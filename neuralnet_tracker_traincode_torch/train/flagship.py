"""The flagship training configuration (the JAX package's `bench.py:196-238`
and `scripts/profile_step.py:_trainer`): MobileNetV1 x1.0 with the point
head and the NLL uncertainty heads under bf16 autocast, the 8-term
`MaskedMultiTaskCriterion`, image augmentation on, 448^2 uint8 sources
cropped to 129^2. `scripts/profile_step.py` and `chip_smoke.py` build it
here."""

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from neuralnet_tracker_traincode_torch.device import DeviceLike

SRC, INPUTSIZE = 448, 129

def flagship_criterion():
    from neuralnet_tracker_traincode_torch.data.fields import Tag
    from neuralnet_tracker_traincode_torch.losses import losses as L
    from neuralnet_tracker_traincode_torch.losses import nll as NLL
    from neuralnet_tracker_traincode_torch.losses.criterion import Criterion, CriterionGroup, MaskedMultiTaskCriterion

    terms = [
        Criterion("nllrot", NLL.QuatPoseNLLLoss(), 0.005),
        Criterion("nllcoord", NLL.CorrelatedCoordPoseNLLLoss(), 0.005),
        Criterion("rot", L.QuatPoseLoss("approx_distance"), 1.0),
        Criterion("xy", L.PoseXYLoss("l2"), 0.25),
        Criterion("sz", L.PoseSizeLoss("l2"), 0.25),
        Criterion("points3d", L.Points3dLoss("l2", chin_weight=0.8), 0.5),
        Criterion("box", L.BoxLoss("l2"), 0.01),
        Criterion("quatreg", L.QuaternionNormalizationSoftConstraint(), 1e-6),
    ]
    return MaskedMultiTaskCriterion({Tag.POSE_WITH_LANDMARKS: CriterionGroup(terms)}, [Tag.POSE_WITH_LANDMARKS])


def synthetic_batch(n: int, seed: int = 0, src: int = SRC) -> Dict[str, np.ndarray]:
    """The training batch of the JAX package's bench.py at batch n: uint8
    noise sources of src^2 and fixed labels (other seeds give other images
    and points)."""
    rng = np.random.RandomState(seed)
    return {
        "image": rng.randint(0, 256, size=(n, src, src, 1), dtype=np.uint8),
        "pose": np.tile(np.asarray([0.0, 0, 0, 1], np.float32), (n, 1)),
        "coord": (rng.rand(n, 3) * 100 + 100).astype(np.float32),
        "roi": np.tile(np.asarray([100.0, 100, 350, 350], np.float32), (n, 1)),
        "pt3d_68": (rng.rand(n, 68, 3) * 200 + 100).astype(np.float32),
        "shapeparam": rng.randn(n, 50).astype(np.float32),
        "hasface": np.full((n,), 0.9, np.float32),
        "coord_convention_id": np.zeros((n,), np.int32),
        "tag_id": np.zeros((n,), np.int32),
        "dataset_weight": np.ones((n,), np.float32),
        "param_index": np.arange(n, dtype=np.int32),
    }


def flagship_trainer(
    batchsize: int,
    device: DeviceLike = None,
    config: str = "mobilenetv1",
    backbone_args: Optional[Dict[str, Any]] = None,
    face: bool = False,
    parallel=None,
) -> Tuple[Any, Any, torch.Tensor]:
    """(PoseTrainer, its state from seed 0, the criterion's weights at epoch
    50) of the flagship configuration, or of another backbone (`config`,
    `backbone_args`, the face detector head with `face`) in it."""
    from neuralnet_tracker_traincode_torch.augmentation.pipeline import TrainAugmentationConfig
    from neuralnet_tracker_traincode_torch.data.loader import LABEL_CATEGORIES
    from neuralnet_tracker_traincode_torch.models.posenet import NetworkWithPointHead
    from neuralnet_tracker_traincode_torch.train.loop import PoseTrainer, TrainerConfig

    model = NetworkWithPointHead(enable_point_head=True, enable_uncertainty=True, config=config,
                                 backbone_args=backbone_args or {}, enable_face_detector=face, dtype=torch.bfloat16)
    cfg = TrainerConfig(batchsize=batchsize, epochs=100, samples_per_epoch=10240,
                        aug=TrainAugmentationConfig(inputsize=INPUTSIZE, enable_image_aug=True))
    trainer = PoseTrainer(model, flagship_criterion(), cfg, LABEL_CATEGORIES, device=device, parallel=parallel)
    return trainer, trainer.init_state(torch.Generator().manual_seed(0)), trainer.weight_matrix(50)
