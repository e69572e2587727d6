"""Semantic field categories and dataset tags (the port's own copy of the
JAX package's `data/fields.py`, as far as training and eval need it)."""

import enum


class FieldCategory(enum.StrEnum):
    general = ""
    image = "img"
    quat = "q"
    xys = "xys"
    roi = "roi"
    points = "pts"  # landmarks
    semseg = "seg"


imagelike_categories = (FieldCategory.image, FieldCategory.semseg)

# The fields of a pose sample (the runtime names of the HDF5 pose schema).
POSE_FIELD_CATEGORIES = {
    "image": FieldCategory.image,
    "pose": FieldCategory.quat,
    "coord": FieldCategory.xys,
    "roi": FieldCategory.roi,
    "pt3d_68": FieldCategory.points,
    "shapeparam": FieldCategory.general,
    "hasface": FieldCategory.general,
}


class Tag(enum.Enum):
    """Label configuration of a dataset; selects the loss group during training."""

    POSE_WITH_LANDMARKS = 1
    SELF_SUPERVISED_POSE = 2
    FACE_DETECTION = 3
    ONLY_LANDMARKS = 4
    ONLY_LANDMARKS_25D = 5
    ONLY_POSE = 7
    POSE_WITH_LANDMARKS_3D_AND_2D = 8
    ONLY_LANDMARKS_2D = 9
    SEMSEG = 10
    POSE_WITH_LMKS_NO_SHAPE_PARAMS = 11
