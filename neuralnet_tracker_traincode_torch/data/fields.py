"""Semantic field categories, dataset tags and ids, and the HDF5 field names
(the port's own copy of the JAX package's `data/fields.py`)."""

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


class DatasetId(enum.Enum):
    _300WLP = 2
    SYNFACE = 5
    WFLW_RELABEL = 6
    AFLW2k3d = 8
    BIWI = 9
    WIDER = 11
    _300VW = 12
    LAPA = 13
    REPO_300WLP = 15
    WFLW_LP = 16
    LAPA_MEGAFACE_LP = 17
    REPO_300WLP_WO_EXTRA = 18
    PANOPTIC_CMU = 19
    REPLICANT_FACE = 20


# HDF5 dataset names -> runtime field names.
inconsistent_name_mapping = {
    "images": "image",
    "keys": "image",
    "seg_image": "semseg",
    "rois": "roi",
    "coords": "coord",
    "quats": "pose",
    "pt3d_68": "pt3d_68",
    "pt2d_68": "pt2d_68",
    "shapeparams": "shapeparam",
    "hasface": "hasface",
}

field_default_names = {
    FieldCategory.image: "images",
    FieldCategory.semseg: "semseg",
    FieldCategory.quat: "quats",
    FieldCategory.xys: "coords",
    FieldCategory.roi: "rois",
}
