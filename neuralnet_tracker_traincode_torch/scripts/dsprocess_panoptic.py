"""CMU Panoptic Studio -> pose-training HDF5 pieces (counterpart of the JAX
package's `scripts/dsprocess_panoptic.py`).

    python -m neuralnet_tracker_traincode_torch.scripts.dsprocess_panoptic \\
        create-piece SEQUENCE_ROOT CAM OUT.h5 [-n N] [--every 60] [--sv]
        | create-pieces ROOT [ROOT ...] OUT_DIR [-n N] [--every 60] [--sv]
        | shrink-videos DIR [DIR ...] | vis SEQUENCE_ROOT FRAME CAM OUT.png [--sv]

Per-sequence multi-camera face-crop extraction with head poses derived from
the mocap skeleton and the mesh-track face fits:

 * camera model: OpenCV intrinsics and 5-coefficient distortion, and a
   weak-perspective landmark projection that keeps z;
 * head pose: the rotation of the meshTrack face fit, the centre at the eye
   midpoint, the size 0.5 * 1.4 * the ear distance;
 * confidence gating: face points near the skull, skeleton confidences above
   0.1, the ear axis aligned with the fitted rotation;
 * projection to each HD camera: a frustum check, the projected size from
   the determinant of the projected trapezoid, the rotation composed with the
   camera's and corrected by the look-at transform of the face position;
 * the box from projected face-model vertices and a head sphere; a crop is
   kept from 64 px and unless self-occluded (at least 45 degrees away from
   the camera or a third of the landmarks visible);
 * output: image (variable-size JPEG), roi f2, quat f4, xys f4, individual,
   frame, sequence, cam; the inaccurate face landmarks are not saved.

Frames are read with cv2.VideoCapture; the face-model vertices for the box
come from the port's full BFM where `$BFM_PATH` names it, else from its
68-keypoint model (`facemodel/bfm.py`). Host only: cv2, h5py, scipy and
matplotlib are imported inside the functions.
"""

import argparse
import dataclasses
import json
import os
import re
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

HDCAM_PANEL = 0
NOSE, LEYE, REYE, LEAR, REAR = 1, 15, 17, 16, 18
FACE_SIZE_FACTOR = 1.4
FACE_NOT_CHIN = list(range(17, 68))
MIN_BBOX_SIZE = 64
PADDING_FRACTION = 0.25
SELF_OCCLUSION_ANGLE_DEG = 45.0
MIN_VISIBLE_POINTS = 68 // 3


def _face_vertices() -> np.ndarray:
    """Vertex cloud used to project the head bounding box.

    Reference samples 5000 full-BFM vertices (:74-77); without the BFM blob
    the 68-keypoint subset serves as the hull approximation.
    """
    from scipy.spatial.transform import Rotation

    from neuralnet_tracker_traincode_torch.facemodel.bfm import BFMModel, FullBFMModel

    rnd = np.random.RandomState(seed=123456)
    if os.environ.get("BFM_PATH"):
        verts = FullBFMModel(os.environ["BFM_PATH"]).scaled_vertices
        verts = verts[rnd.choice(len(verts), size=5000)]
    else:
        verts = BFMModel().keypts
    verts = Rotation.from_rotvec([np.pi, 0.0, 0.0]).apply(verts)
    return np.ascontiguousarray(verts)


def _sphere_points() -> np.ndarray:
    rnd = np.random.RandomState(seed=654321)
    p = rnd.normal(size=(1000, 3))
    return p / np.linalg.norm(p, axis=1, keepdims=True)


def project_points(X, K, R, t, Kd) -> np.ndarray:
    """OpenCV-style distorted pinhole projection of (N, 3) points -> (N, 2)."""
    x = (R @ X.T + t)  # (3, N)
    x = x[:2] / x[2]
    r2 = x[0] ** 2 + x[1] ** 2
    radial = 1 + Kd[0] * r2 + Kd[1] * r2**2 + Kd[4] * r2**3
    u = x[0] * radial + 2 * Kd[2] * x[0] * x[1] + Kd[3] * (r2 + 2 * x[0] ** 2)
    v = x[1] * radial + 2 * Kd[3] * x[0] * x[1] + Kd[2] * (r2 + 2 * x[1] ** 2)
    # K[1,0] is zero for these cameras; the reference feeds the already
    # transformed u into the second row, which is inert for that reason.
    pu = K[0, 0] * u + K[0, 1] * v + K[0, 2]
    pv = K[1, 1] * v + K[1, 2]
    return np.stack([pu, pv], axis=-1)


def project_points_weak_perspective(X, Xref, K, R, t, Kd) -> np.ndarray:
    """Weak-perspective projection around reference point; keeps scaled z."""
    x = (R @ X.T + t)  # (3, N)
    xref = (R @ Xref[:, None] + t)[:, 0]
    x = x / xref[2]
    xref = xref / xref[2]
    r2 = xref[0] ** 2 + xref[1] ** 2
    radial = 1 + Kd[0] * r2 + Kd[1] * r2**2 + Kd[4] * r2**3
    u = x[0] * radial + 2 * Kd[2] * xref[0] * xref[1] + Kd[3] * (r2 + 2 * xref[0] ** 2)
    v = x[1] * radial + 2 * Kd[3] * xref[0] * xref[1] + Kd[2] * (r2 + 2 * xref[1] ** 2)
    z = x[2] * radial
    pu = K[0, 0] * u + K[0, 1] * v + K[0, 2]
    pv = K[1, 1] * v + K[1, 2]
    pz = np.sqrt(np.linalg.det(K[:2, :2])) * z
    return np.stack([pu, pv, pz], axis=-1)


def make_look_at_matrix(pos: np.ndarray) -> np.ndarray:
    """z axis aligned with pos; x constrained to the horizontal plane."""
    z = pos / np.linalg.norm(pos)
    x = np.cross([0.0, 1.0, 0.0], z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    y = y / np.linalg.norm(y)
    return np.stack([x, y, z], axis=-1)


@dataclasses.dataclass
class Pose:
    rot: "Rotation"  # scipy's
    t: np.ndarray
    size: float
    valid: bool = True

    @staticmethod
    def dummy(ndims=3):
        from scipy.spatial.transform import Rotation

        return Pose(Rotation.identity(), np.zeros((ndims,)), 0.0, valid=False)


class Camera:
    def __init__(self, json_data: Dict[str, Any]):
        self.K = np.asarray(json_data["K"], np.float64)
        self.R = np.asarray(json_data["R"], np.float64)
        self.t = np.asarray(json_data["t"], np.float64).reshape(3, 1)
        self.dist = np.asarray(json_data["distCoef"], np.float64)
        self.width = int(json_data["resolution"][0])
        self.height = int(json_data["resolution"][1])
        self.id = int(json_data["node"])

    def project(self, points: np.ndarray) -> np.ndarray:
        prefix = points.shape[:-1]
        p = project_points(points.reshape(-1, 3), self.K, self.R, self.t, self.dist)
        return p.reshape(*prefix, 2)

    def project_weak_perspective(self, points: np.ndarray, ref: np.ndarray) -> np.ndarray:
        prefix = points.shape[:-1]
        p = project_points_weak_perspective(
            points.reshape(-1, 3), ref, self.K, self.R, self.t, self.dist
        )
        return p.reshape(*prefix, 3)

    def project_pose(self, pose: Pose) -> Pose:
        """Project center + estimate screen-space size via the local jacobian."""
        from scipy.spatial.transform import Rotation

        if not pose.valid:
            return Pose.dummy(ndims=2)
        eps = 1.0e-3
        # Center plus points offset along the camera axes.
        probes = pose.t[None, :] + eps * np.concatenate([self.R.T.T, np.zeros((1, 3))], axis=0)
        p = self.project(probes)
        in_image = (
            (p[:, 0] > 0) & (p[:, 1] > 0) & (p[:, 0] < self.width) & (p[:, 1] < self.height)
        )
        z = (self.R @ pose.t[:, None] + self.t)[2, 0]
        is_in_frustum = bool(np.all(in_image) and (z > pose.size))
        center = p[-1]
        delta = (p[:-1] - center[None, :]) / eps
        scale = np.sqrt(np.abs(np.linalg.det(delta[:2, :2])))
        rotation = Rotation.from_matrix(self.R) * pose.rot
        return Pose(rotation, center, scale * pose.size, valid=is_in_frustum)

    def perspective_corrected_rotation(self, world_position: np.ndarray, rot):
        """Express the pose in the frame the CNN sees through its off-center crop."""
        from scipy.spatial.transform import Rotation

        cam_position = (self.R @ world_position[:, None] + self.t)[:, 0]
        m = make_look_at_matrix(cam_position)
        return Rotation.from_matrix(m).inv() * rot


class Body:
    def __init__(self, id, points, face_points, face_points_visibility, rot):
        self.id = id
        self.points = points  # (19, 4) xyz + confidence
        self.face_points = face_points  # (70, 3)
        self.face_points_visibility = face_points_visibility  # (ncams, 70)
        self.head_pose = self._head_pose(rot)
        self.head_pose.valid = self._head_pose_is_confident()

    def _head_pose(self, rot) -> Pose:
        l, r = self.points[[LEYE, REYE], :3]
        center = 0.5 * (l + r)
        l, r = self.points[[LEAR, REAR], :3]
        size = 0.5 * FACE_SIZE_FACTOR * np.linalg.norm(l - r)
        return Pose(rot, center, size)

    def _head_pose_is_confident(self) -> bool:
        ref = self.points[[LEYE, REYE, LEAR, REAR], :3]
        skull_center = np.average(ref, axis=0)
        skull_radius = 0.5 * np.average(np.linalg.norm(ref - skull_center, axis=-1))
        face_visible = bool(
            np.all(np.any(self.face_points_visibility[:, FACE_NOT_CHIN], axis=0))
        )
        in_face_area = bool(
            np.all(
                np.linalg.norm(self.face_points[FACE_NOT_CHIN] - skull_center, axis=-1)
                < 3 * skull_radius
            )
        )
        confident = bool(np.all(self.points[[LEYE, REYE, LEAR, REAR, NOSE], 3] > 0.1))
        lear, rear = self.points[[LEAR, REAR], :3]
        ear_axis = lear - rear
        x_axis = self.head_pose.rot.as_matrix()[:, 0]
        aligned = bool(np.inner(x_axis, ear_axis) > 0.8 * np.linalg.norm(ear_axis))
        return face_visible and in_face_area and confident and aligned

    def face_vertices_for_bbox(self, face_vertices, sphere_points) -> np.ndarray:
        lear, rear = self.points[[LEAR, REAR], :3]
        center = 0.5 * (lear + rear)
        size = 0.5 * np.linalg.norm(lear - rear)
        v_sphere = (
            size * self.head_pose.rot.apply(sphere_points + np.asarray([0.0, 0.25, 0.0]))
            + center
        )
        v_face = (
            self.head_pose.size * self.head_pose.rot.apply(face_vertices) + self.head_pose.t
        )
        return np.concatenate([v_face, v_sphere])

    def guestimate_head_bounding_box(self, cam, face_vertices, sphere_points) -> np.ndarray:
        pts = cam.project(self.face_vertices_for_bbox(face_vertices, sphere_points))
        return np.concatenate([pts.min(axis=0), pts.max(axis=0)], axis=-1)


def _parse_skeletons(json_skel) -> Dict[int, np.ndarray]:
    return {
        body["id"]: np.asarray(body["joints19"], np.float64).reshape(-1, 4)
        for body in json_skel["bodies"]
    }


def _parse_mesh_track(face_raw: str) -> Dict[int, Any]:
    """meshTrack face fit file: the rotvec 2 lines after each 'Face' header,
    the individual id 5 lines before (reference __parse_face_raw_fit)."""
    from scipy.spatial.transform import Rotation

    out = {}
    lines = face_raw.splitlines()[2:]
    for i, line in enumerate(lines):
        if not line.startswith("Face"):
            continue
        individual = int(lines[i - 5].strip())
        rotvec = np.asarray([float(v) for v in lines[i + 2].split()])
        out[individual] = Rotation.from_rotvec(rotvec)
    return out


def _parse_face_landmarks(json_face, num_hdcams=31):
    out = {}
    for face in json_face["people"]:
        individual = face["id"]
        if individual < 0:  # dummy data in the dumps
            continue
        lmks = np.asarray(face["face70"]["landmarks"], np.float64).reshape(-1, 3)
        vis = np.zeros((num_hdcams, lmks.shape[0]), bool)
        for point_idx, cam_ids in enumerate(face["face70"]["visibility"]):
            vis[cam_ids, point_idx] = True
        out[individual] = (lmks, vis)
    return out


def load_bodies(directory: Path, frame_num: int) -> List[Body]:
    with open(directory / "hdPose3d_stage1_coco19" / f"body3DScene_{frame_num:08}.json") as f:
        skeletons = _parse_skeletons(json.load(f))
    with open(directory / "meshTrack_face" / f"meshTrack_{frame_num:08}.txt") as f:
        fits = _parse_mesh_track(f.read())
    with open(directory / "hdFace3d" / f"faceRecon3D_hd{frame_num:08d}.json") as f:
        landmarks = _parse_face_landmarks(json.load(f))
    common = set(skeletons) & set(fits) & set(landmarks)
    return [
        Body(i, skeletons[i], landmarks[i][0], landmarks[i][1], fits[i]) for i in sorted(common)
    ]


class PanopticSequence:
    _re_body = re.compile(r"body3DScene_(\d*).json")
    _re_track = re.compile(r"meshTrack_(\d*).txt")
    _re_lmk = re.compile(r"faceRecon3D_hd(\d*).json")

    def __init__(self, directory):
        self.directory = Path(directory)
        with open(next(iter(self.directory.glob("calibration_*.json")))) as f:
            calib = json.load(f)
        self.cameras = {
            int(c["node"]): Camera(c) for c in calib["cameras"] if int(c["panel"]) == HDCAM_PANEL
        }
        self.frame_nums = self._discover_frames()

    def _discover_frames(self) -> List[int]:
        def ids(subdir, rx):
            path = self.directory / subdir
            if not path.is_dir():
                raise ValueError(f"Sequence {self.directory} is missing {subdir}")
            return set(int(rx.match(p.name).group(1)) for p in path.iterdir() if rx.match(p.name))

        frames = (
            ids("hdPose3d_stage1_coco19", self._re_body)
            & ids("meshTrack_face", self._re_track)
            & ids("hdFace3d", self._re_lmk)
        )
        assert frames, f"Label files missing in {self.directory}"
        return sorted(frames)


VIDEOS_DIR = "hdVideos"
# Recompressed (same-resolution, lower-bitrate) copies; the reference supports
# reading them but warns the recompression measurably hurts model accuracy
# (`dsprocess_panoptic.py:994-995`).
SHRINKED_VIDEOS_DIR = "hdVideosShrinked"


def stream_frames(
    sequence_dir: Path, cam_id: int, max_num_frames: Optional[int],
    videos_dir: str = VIDEOS_DIR,
):
    """Decode hd_00_XX.mp4 with cv2.VideoCapture (reference pipes ffmpeg)."""
    import cv2

    video_fn = sequence_dir / videos_dir / f"hd_{HDCAM_PANEL:02}_{cam_id:02}.mp4"
    if not video_fn.exists():
        raise RuntimeError(f"Video missing: {video_fn}")
    cap = cv2.VideoCapture(str(video_fn))
    n = 0
    while cap.isOpened():
        ok, frame = cap.read()
        if not ok or (max_num_frames is not None and n >= max_num_frames):
            break
        yield n, frame[..., ::-1]  # BGR -> RGB
        n += 1
    cap.release()


def is_image_reasonable(crop: np.ndarray) -> bool:
    """Mostly-uniform frames probably contain no person."""
    return bool(np.any(np.std(crop, axis=(0, 1)) > 5.0))


def _not_self_occluded(pose: Pose, body: Body, cam_id: int) -> bool:
    cos_angle = -pose.rot.as_matrix()[:, 2] @ np.asarray([0.0, 0.0, 1.0])
    num_vis = int(np.count_nonzero(body.face_points_visibility[cam_id]))
    return (cos_angle < np.cos(np.deg2rad(SELF_OCCLUSION_ANGLE_DEG))) or (
        num_vis >= MIN_VISIBLE_POINTS
    )


def iterate_crops(
    sequence_dir, cam_id: int, max_num_frames=None, every: int = 60,
    use_shrinked_videos: bool = False,
):
    from neuralnet_tracker_traincode_torch.data.preprocessing import extract_image_roi

    sequence_dir = Path(sequence_dir)
    panseq = PanopticSequence(sequence_dir)
    labeled = frozenset(panseq.frame_nums)
    cam = panseq.cameras[cam_id]
    face_vertices = _face_vertices()
    sphere_points = _sphere_points()
    videos_dir = SHRINKED_VIDEOS_DIR if use_shrinked_videos else VIDEOS_DIR

    for frame_num, frame_img in stream_frames(sequence_dir, cam_id, max_num_frames, videos_dir):
        if frame_num not in labeled or frame_num % every != 0:
            continue
        for body in load_bodies(sequence_dir, frame_num):
            pose = body.head_pose
            ppose = cam.project_pose(pose)
            if not ppose.valid:
                continue
            ppose.rot = cam.perspective_corrected_rotation(pose.t, ppose.rot)
            bbox = body.guestimate_head_bounding_box(cam, face_vertices, sphere_points)
            if not np.all(bbox[2:] - bbox[:2] > MIN_BBOX_SIZE):
                continue
            if not _not_self_occluded(ppose, body, cam_id):
                continue
            crop, offset = extract_image_roi(
                np.asarray(frame_img), bbox.copy(),
                padding_fraction=PADDING_FRACTION, square=True, return_offset=True,
            )
            if not is_image_reasonable(crop):
                continue
            ppose.t = ppose.t + offset
            bbox = bbox + np.concatenate([offset, offset])
            yield crop, ppose, bbox, body.id, frame_num


def write_dataset_piece(out_fn, sequence_dir, cam_id, max_num_frames=None, every: int = 60,
                        use_shrinked_videos: bool = False):
    import cv2
    import h5py
    from scipy.spatial.transform import Rotation

    from neuralnet_tracker_traincode_torch.data.fields import FieldCategory
    from neuralnet_tracker_traincode_torch.data.pose_dataset import create_pose_dataset

    PanopticSequence(sequence_dir)  # readability check before creating the file
    images, quats, rects, xys, individuals, frame_nums = [], [], [], [], [], []
    # The mocap y axis points up; our screen y points down (same flip the
    # reference applies via rot_correction, :832 & :838).
    rot_correction = Rotation.from_rotvec([np.pi, 0.0, 0.0])
    for crop, ppose, bbox, individual, frame_num in iterate_crops(
        sequence_dir, cam_id, max_num_frames, every, use_shrinked_videos
    ):
        gray = cv2.cvtColor(crop, cv2.COLOR_RGB2GRAY) if crop.ndim == 3 else crop
        images.append(gray)
        quats.append((ppose.rot * rot_correction).as_quat())
        rects.append(bbox)
        xys.append(np.concatenate([ppose.t, [ppose.size]]))
        individuals.append(individual)
        frame_nums.append(frame_num)

    N = len(images)
    if N == 0:
        print(f"No valid crops for cam {cam_id}; not writing {out_fn}")
        return
    individuals = np.asarray(individuals, "i1")
    frame_nums = np.asarray(frame_nums, "i4")
    order = np.argsort(frame_nums.astype(np.int64) + frame_nums.max() * individuals.astype(np.int64))

    with h5py.File(str(out_fn), "w") as f:
        ds_img = create_pose_dataset(f, FieldCategory.image, count=N)
        for i, src in enumerate(order):
            ds_img[i] = images[src]
        create_pose_dataset(f, FieldCategory.roi, data=np.stack(rects)[order], dtype="f2")
        create_pose_dataset(f, FieldCategory.quat, data=np.stack(quats)[order], dtype="f4")
        create_pose_dataset(f, FieldCategory.xys, data=np.stack(xys)[order], dtype="f4")
        create_pose_dataset(
            f, FieldCategory.general, name="individual", data=individuals[order]
        )
        f.create_dataset("frame", data=frame_nums[order])
        f.create_dataset(
            "sequence",
            data=np.asarray([Path(sequence_dir).name.encode("ascii")], "|S32").repeat(N),
        )
        f.create_dataset("cam", data=np.asarray([cam_id], "i1").repeat(N))
    print(f"Wrote {out_fn}: {N} crops")


def write_dataset_pieces(out_dir, sequence_dirs, max_num_frames=None, every: int = 60,
                         use_shrinked_videos: bool = False):
    os.makedirs(out_dir, exist_ok=True)
    for sequence_dir in sequence_dirs:
        for cam_id in PanopticSequence(sequence_dir).cameras:
            out_fn = Path(out_dir) / f"{Path(sequence_dir).name}_hdcam_{cam_id:02}.h5"
            if out_fn.exists():
                print(f"Skipped existing {out_fn}")
                continue
            write_dataset_piece(
                out_fn, sequence_dir, cam_id, max_num_frames, every, use_shrinked_videos
            )


def shrink_videos(directories):
    """Two-pass x264 recompression into hdVideosShrinked/ (reference
    `shrink_videos`, which itself warns: the recompression artifacts measurably
    hurt model accuracy — prefer the originals)."""
    import subprocess

    for directory in map(Path, directories):
        os.makedirs(directory / SHRINKED_VIDEOS_DIR, exist_ok=True)
        for input_fn in sorted((directory / VIDEOS_DIR).glob("*.mp4")):
            output = directory / SHRINKED_VIDEOS_DIR / input_fn.name
            if output.exists():
                print("Skipped", input_fn)
                continue
            subprocess.check_call([
                "ffmpeg", "-i", str(input_fn), "-c:v", "libx264", "-b:v", "4M",
                "-pass", "1", "-an", "-f", "null", os.devnull,
            ])
            subprocess.check_call([
                "ffmpeg", "-i", str(input_fn), "-c:v", "libx264", "-b:v", "4M",
                "-pass", "2", "-minrate", "1M", "-maxrate", "6M", "-an", str(output),
            ])


def vis_frame(sequence_dir, frame_num: int, cam_id: int, out_png: str,
              use_shrinked_videos: bool = False):
    """Render one frame's bodies (pose circle, axes, bbox, projected face
    points) to a PNG — headless replacement for the reference's vis_one /
    vis_crop_labels matplotlib browsers."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.patches as mpatches
    import matplotlib.pyplot as plt

    sequence_dir = Path(sequence_dir)
    panseq = PanopticSequence(sequence_dir)
    cam = panseq.cameras[cam_id]
    videos_dir = SHRINKED_VIDEOS_DIR if use_shrinked_videos else VIDEOS_DIR
    frame_img = None
    for n, img in stream_frames(sequence_dir, cam_id, frame_num + 1, videos_dir):
        if n == frame_num:
            frame_img = img
    assert frame_img is not None, f"frame {frame_num} not reachable"

    face_vertices = _face_vertices()
    sphere_points = _sphere_points()
    fig, ax = plt.subplots(1, 1, figsize=(15, 15))
    ax.imshow(frame_img)
    ax.set_autoscale_on(False)
    for body in load_bodies(sequence_dir, frame_num):
        pose = body.head_pose
        ppose = cam.project_pose(pose)
        if not ppose.valid:
            continue
        pts = cam.project(body.face_points)
        vis = body.face_points_visibility[cam_id]
        ax.scatter(pts[vis, 0], pts[vis, 1], color="w", s=2.0)
        ax.scatter(pts[~vis, 0], pts[~vis, 1], color="r", s=2.0)
        ax.add_artist(mpatches.Circle(ppose.t, ppose.size, ec="w", fc="none"))
        axis_scale = 10.0  # cm in world units, projected
        xyz_proj = cam.project(pose.t[None, :] + axis_scale * pose.rot.as_matrix().T)
        for e, c in zip(xyz_proj, "rgb"):
            ax.plot([ppose.t[0], e[0]], [ppose.t[1], e[1]], color=c)
        bbox = body.guestimate_head_bounding_box(cam, face_vertices, sphere_points)
        ax.add_artist(mpatches.Rectangle(
            bbox[:2], bbox[2] - bbox[0], bbox[3] - bbox[1], ec="r", fc="none"
        ))
    fig.savefig(out_png, bbox_inches="tight")
    plt.close(fig)
    print(f"Wrote {out_png}")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = parser.add_subparsers(required=True)

    piece = sub.add_parser("create-piece", help="one sequence x one camera -> h5")
    piece.add_argument("sequence_root")
    piece.add_argument("cam", type=int)
    piece.add_argument("output")
    piece.add_argument("-n", type=int, default=None, help="max frames to scan")
    piece.add_argument("--every", type=int, default=60, help="use every n-th labeled frame")
    piece.add_argument("--sv", action="store_true", default=False,
                       help="read the recompressed hdVideosShrinked/ copies")
    piece.set_defaults(
        func=lambda a: write_dataset_piece(a.output, a.sequence_root, a.cam, a.n, a.every, a.sv)
    )

    pieces = sub.add_parser("create-pieces", help="all sequences x all HD cameras")
    pieces.add_argument("roots", nargs="*")
    pieces.add_argument("output")
    pieces.add_argument("-n", type=int, default=None)
    pieces.add_argument("--every", type=int, default=60)
    pieces.add_argument("--sv", action="store_true", default=False)
    pieces.set_defaults(
        func=lambda a: write_dataset_pieces(a.output, a.roots, a.n, a.every, a.sv)
    )

    shrink = sub.add_parser(
        "shrink-videos",
        help="two-pass x264 recompression into hdVideosShrinked/ "
             "(reference warns this hurts accuracy; prefer the originals)",
    )
    shrink.add_argument("directories", nargs="*")
    shrink.set_defaults(func=lambda a: shrink_videos(a.directories))

    vis = sub.add_parser("vis", help="render one frame's labels to a PNG")
    vis.add_argument("sequence_root")
    vis.add_argument("frame", type=int)
    vis.add_argument("cam", type=int)
    vis.add_argument("output")
    vis.add_argument("--sv", action="store_true", default=False)
    vis.set_defaults(
        func=lambda a: vis_frame(a.sequence_root, a.frame, a.cam, a.output, a.sv)
    )

    return parser


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    args.func(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
