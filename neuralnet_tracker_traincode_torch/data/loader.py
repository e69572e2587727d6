"""The category of each label of the fused batch (counterpart of the JAX
package's `data/loader.py:LABEL_CATEGORIES`). The host loader itself
(`FusedBatchLoader`, the shared-memory workers) waits (ROADMAP.md).
"""

from neuralnet_tracker_traincode_torch.data.fields import FieldCategory

LABEL_CATEGORIES = {
    "pose": FieldCategory.quat,
    "coord": FieldCategory.xys,
    "roi": FieldCategory.roi,
    "pt3d_68": FieldCategory.points,
    "shapeparam": FieldCategory.general,
    "hasface": FieldCategory.general,
}
