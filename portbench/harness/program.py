"""The system under test, built from a configuration file: the port's pose
trainer (`PoseTrainer`) with the configuration's network, criterion,
augmentation and optimizer settings. The port is imported here and in the
run's feeds only, never by the reference."""

from typing import Dict

import torch

def criterion(config: Dict):
    from neuralnet_tracker_traincode_torch.data.fields import Tag
    from neuralnet_tracker_traincode_torch.losses import losses as L
    from neuralnet_tracker_traincode_torch.losses import nll as NLL
    from neuralnet_tracker_traincode_torch.losses.criterion import (
        Criterion,
        CriterionGroup,
        MaskedMultiTaskCriterion,
    )

    terms = []
    for t in config["criterion"]:
        cls = getattr(NLL, t["loss"], None) or getattr(L, t["loss"])
        terms.append(Criterion(t["name"], cls(*t.get("args", []), **t.get("kwargs", {})), float(t["weight"])))
    tag = Tag.POSE_WITH_LANDMARKS
    return MaskedMultiTaskCriterion({tag: CriterionGroup(terms)}, [tag])


def trainer(config: Dict, device):
    """(PoseTrainer on `device`, the criterion's weight matrix on the device)."""
    from neuralnet_tracker_traincode_torch.augmentation.pipeline import TrainAugmentationConfig
    from neuralnet_tracker_traincode_torch.data.loader import LABEL_CATEGORIES
    from neuralnet_tracker_traincode_torch.models.posenet import NetworkWithPointHead
    from neuralnet_tracker_traincode_torch.train.loop import PoseTrainer, TrainerConfig
    from neuralnet_tracker_traincode_torch.train.schedules import exponential_up_then_steps

    model = NetworkWithPointHead(
        enable_point_head=config["enable_point_head"], enable_face_detector=config["enable_face_detector"],
        config=config["backbone"], enable_uncertainty=config["enable_uncertainty"],
        use_local_pose_offset=config["use_local_pose_offset"], backbone_args=config.get("backbone_args", {}),
        enable_6drot=config["enable_6drot"], dtype=getattr(torch, config["dtype"]),
        input_resolution=config["inputsize"])
    opt = config["optimizer"]
    kind, num_up, gamma, steps = opt["schedule"]
    if kind != "exponential_up_then_steps":
        raise ValueError(f"no schedule {kind}")
    cfg = TrainerConfig(batchsize=opt["batchsize"], lr=opt["lr"], epochs=opt["epochs"],
                        samples_per_epoch=opt["samples_per_epoch"], grad_clip_norm=opt["grad_clip_norm"],
                        aug=TrainAugmentationConfig(inputsize=config["inputsize"], **config["augmentation"]))
    tr = PoseTrainer(model, criterion(config), cfg, LABEL_CATEGORIES,
                     epoch_schedule=exponential_up_then_steps(num_up, gamma, steps), device=device)
    return tr, tr.weight_matrix(opt["weight_epoch"])


def state_tensors(tr, state) -> Dict[str, Dict[str, torch.Tensor]]:
    """Host copies of what a step changes: the state dict (parameters and
    BatchNorm statistics) and Adam's moments, by name."""
    sd = {k: v.detach().float().cpu().clone() for k, v in tr.model.state_dict().items()}
    opt = state.opt_state
    return {"state": sd, "mu": {k: v.float().cpu().clone() for k, v in opt.mu.items()},
            "nu": {k: v.float().cpu().clone() for k, v in opt.nu.items()}}
