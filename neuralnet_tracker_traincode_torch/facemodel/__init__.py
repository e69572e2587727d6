"""Face model: 68-keypoint semantics and the deformable keypoint subset."""
