"""One rank of a data-parallel run of the port on the CPU (gloo), for
`tests/test_torch_parallel.py`. It imports nothing of JAX: the test process
computes the references.

    python tests/torch_dp_worker.py CASE WORKDIR

with `torchrun`'s variables (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`,
`LOCAL_WORLD_SIZE`, `MASTER_ADDR`, `MASTER_PORT`) in the environment. It
reads `WORKDIR/inputs.pt` and writes what it computed to
`WORKDIR/CASE_rank{RANK}.pt`. Any error ends the process with a traceback
and a non-zero exit code, which breaks the other ranks' collectives too.

Cases: `two` (2 ranks: synchronized BatchNorm with uneven rows, K1's agreed
plan, the loader's rows and agreed padding, the flagship step with injected
draws, a K = 2 block with image augmentation and sequences across the ranks'
edge, the device part's read-backs, efficientnet_b0 with stochastic depth),
`nodes` (4 ranks as 2 nodes x 2: the training CLI's loaders),
`flagship_nodes` (4 ranks as 2 nodes x 2: the flagship step with injected
draws, each node's batch in its own row numbers), `cli` (the training CLI
itself, each rank in its own output directory or all in one).
"""

import os
import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from neuralnet_tracker_traincode_torch.augmentation.pipeline import TrainAugmentationConfig  # noqa: E402
from neuralnet_tracker_traincode_torch.data.fields import Tag  # noqa: E402
from neuralnet_tracker_traincode_torch.data.loader import LABEL_CATEGORIES  # noqa: E402
from neuralnet_tracker_traincode_torch.losses import criterion as TC, losses as TL, nll as TNLL  # noqa: E402
from neuralnet_tracker_traincode_torch.models.posenet import NetworkWithPointHead  # noqa: E402
from neuralnet_tracker_traincode_torch.parallel.distributed import init_from_env  # noqa: E402
from neuralnet_tracker_traincode_torch.train.loop import PoseTrainer, TrainerConfig  # noqa: E402

SMALL_NET = dict(enable_point_head=True, enable_uncertainty=True, config="mobilenetv1",
                 backbone_args={"widen_factor": 0.25})
TABLE = [1.0, 0.5, 0.25, 2.0]


def flagship_criterion():
    terms = [
        ("nllrot", TNLL.QuatPoseNLLLoss(), 0.005),
        ("nllcoord", TNLL.CorrelatedCoordPoseNLLLoss(), 0.005),
        ("rot", TL.QuatPoseLoss("approx_distance"), 1.0),
        ("xy", TL.PoseXYLoss("l2"), 0.25),
        ("sz", TL.PoseSizeLoss("l2"), 0.25),
        ("points3d", TL.Points3dLoss("l2", chin_weight=0.8), 0.5),
        ("box", TL.BoxLoss("l2"), 0.01),
        ("quatreg", TL.QuaternionNormalizationSoftConstraint(), 1e-6),
    ]
    return TC.MaskedMultiTaskCriterion({Tag.POSE_WITH_LANDMARKS: TC.CriterionGroup([TC.Criterion(*a) for a in terms])},
                                       [Tag.POSE_WITH_LANDMARKS])


def trainer_of(dp, aug: dict, net=SMALL_NET, state_dict=None, batchsize=8):
    model = NetworkWithPointHead(**net)
    cfg = TrainerConfig(batchsize=batchsize, lr=1e-3, epochs=4, samples_per_epoch=4 * batchsize,
                        aug=TrainAugmentationConfig(**aug))
    trainer = PoseTrainer(model, flagship_criterion(), cfg, LABEL_CATEGORIES, lambda e: TABLE[e], device="cpu",
                          parallel=dp)
    if state_dict is None:
        return trainer, trainer.init_state(torch.Generator().manual_seed(0))
    return trainer, trainer.init_state(state_dict=state_dict)


def snapshot(trainer, state, metrics):
    opt = state.opt_state
    clone = lambda tree: {k: v.detach().clone() for k, v in tree.items()}  # noqa: E731
    return dict(metrics=clone(metrics), model=clone(trainer.model.state_dict()), mu=clone(opt.mu), nu=clone(opt.nu),
                count=int(opt.count), step=state.step)


def rows_of(batch, rows):
    return {k: v[rows] for k, v in batch.items()}


class ReadBacks(TorchDispatchMode):
    """The ops that read a value back to the host or whose output shape
    depends on values (as `tests/test_torch_multistep.py` records them)."""

    FORBIDDEN = ("_local_scalar_dense", "nonzero", "masked_select", "unique", "_unique2", "repeat_interleave",
                 "lift_fresh")

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.__name__.split(".")[0] in self.FORBIDDEN:
            self.seen.append(str(func))
        return func(*args, **(kwargs or {}))


def case_two(dp, inputs):
    out = {}
    # synchronized BatchNorm: 3 rows on rank 0, 1 on rank 1
    from neuralnet_tracker_traincode_torch.models.backbones.common import BatchNorm2d

    bn_in = inputs["bn"]
    rows = slice(0, 3) if dp.rank == 0 else slice(3, 4)
    bn = BatchNorm2d(bn_in["x"].shape[1])
    with torch.no_grad():
        for k in ("weight", "bias", "running_mean", "running_var"):
            getattr(bn, k).copy_(torch.from_numpy(bn_in[k]))
    bn.sync = dp
    x = torch.from_numpy(bn_in["x"][rows]).requires_grad_()
    y = bn(x)
    (y * torch.from_numpy(bn_in["dy"][rows])).sum().backward()
    out["bn"] = dict(y=y.detach(), dx=x.grad, dweight=bn.weight.grad, dbias=bn.bias.grad,
                     running_mean=bn.running_mean.clone(), running_var=bn.running_var.clone())

    # K1's plan from each rank's own ROIs, and agreed
    from neuralnet_tracker_traincode_torch.augmentation.pipeline import crop_scale_bounds
    from neuralnet_tracker_traincode_torch.kernels import warp as K1

    plan_in = inputs["plan"]
    trainer, _ = trainer_of(dp, plan_in["aug"])
    batch = rows_of(plan_in["batch"], dp.rows(8))
    aug, _ = trainer._draws(batch, plan_in["draws"], None)
    cfg = trainer.config.aug
    own = crop_scale_bounds(torch.from_numpy(batch["roi"]), aug, trainer.categories, cfg)
    cs = K1.canvas_size(cfg.inputsize, cfg.rotation_aug_angle)
    out["plan"] = dict(own=K1.rounded_plan(batch["image"].shape[2], cs, True, *own),
                       agreed=trainer.k1_plan([batch], [aug]))

    # the loader: this rank's rows of the node's batches, padded as the ranks agree
    from neuralnet_tracker_traincode_torch.data import pose_dataset as TP
    from neuralnet_tracker_traincode_torch.data.loader import FusedBatchLoader
    from neuralnet_tracker_traincode_torch.data.sampling import ConcatDataset, make_concat_dataset_item_sampler

    concat = ConcatDataset([TP.Hdf5PoseDataset(inputs["loader"]["file"], dataclass=Tag.POSE_WITH_LANDMARKS)])
    sampler = make_concat_dataset_item_sampler(concat, [1.0], stop_after=40, seed=3)
    loader = FusedBatchLoader(concat, lambda i: Tag.POSE_WITH_LANDMARKS, {Tag.POSE_WITH_LANDMARKS: 0}, sampler, 8, 64,
                              num_workers=1, parallel=dp)
    out["loader"] = list(loader)

    # the flagship step with the JAX package's draws of the whole batch, 2 steps
    step_in = inputs["step"]
    trainer, state = trainer_of(dp, step_in["aug"], state_dict=step_in["state_dict"])
    W = trainer.weight_matrix(0)
    out["step"] = []
    for batch, draws in zip(step_in["batches"], step_in["draws"]):
        state, m = trainer.train_step(state, rows_of(batch, dp.rows(8)), W, aug_params=draws)
        out["step"].append(snapshot(trainer, state, m))

    # image augmentation and sequences across the ranks' edge: one block of K = 2 from a generator
    block_in = inputs["block"]
    trainer, state = trainer_of(dp, block_in["aug"], state_dict=step_in["state_dict"])
    gen = torch.Generator().manual_seed(block_in["seed"])
    stacked = {k: v[:, dp.rows(8)] for k, v in block_in["stacked"].items()}
    state, m = trainer.train_step_multi(state, stacked, W, generator=gen)
    out["block"] = snapshot(trainer, state, m)
    inputs_of_step = trainer.prepare_step({k: v[0] for k, v in stacked.items()}, generator=gen)
    with ReadBacks() as mode:
        names, values = trainer.device_step(state, inputs_of_step, W)
    out["read_backs"] = mode.seen

    # a backbone that draws masks: efficientnet_b0 with stochastic depth, 2 rows a rank
    net = dict(enable_point_head=True, enable_uncertainty=True, config="efficientnet_b0")
    trainer, state = trainer_of(dp, block_in["aug"], net=net, batchsize=4)
    gen = torch.Generator().manual_seed(9)
    for batch in inputs["efficientnet"]:
        state, m = trainer.train_step(state, rows_of(batch, dp.rows(4)), trainer.weight_matrix(0), generator=gen)
    out["efficientnet"] = snapshot(trainer, state, m)
    return out


def case_nodes(dp, inputs):
    import itertools

    from neuralnet_tracker_traincode_torch import pipelines
    from neuralnet_tracker_traincode_torch.data.fields import DatasetId

    os.environ["DATADIR"] = inputs["datadir"]
    loader, *_ = pipelines.make_pose_estimation_loaders(inputsize=129, batchsize=8, datasets=[DatasetId._300WLP],
                                                        seed=11, num_workers=1, parallel=dp)
    plans = [tuple(p) for p in itertools.islice(loader.plan_batches(), 3)]
    return dict(plans=plans, batches=list(itertools.islice(iter(loader), 2)))


def case_flagship_nodes(dp, inputs):
    """The flagship step on this rank's rows of the batch of all ranks,
    whose `param_index` holds each node's own row numbers."""
    trainer, state = trainer_of(dp, inputs["aug"], state_dict=inputs["state_dict"])
    W = trainer.weight_matrix(0)
    out = []
    for batch, draws in zip(inputs["batches"], inputs["draws"]):
        state, m = trainer.train_step(state, rows_of(batch, dp.rows(len(batch["tag_id"]))), W, aug_params=draws)
        out.append(snapshot(trainer, state, m))
    return dict(step=out, node=dp.node)


def case_cli(inputs):
    from neuralnet_tracker_traincode_torch.scripts import train_poseestimator

    os.environ["DATADIR"] = inputs["datadir"]
    os.environ["NUM_WORKERS"] = "1"
    outdir = inputs["outdir"] % int(os.environ["RANK"]) if "%d" in inputs["outdir"] else inputs["outdir"]
    return dict(exit=train_poseestimator.main(inputs["argv"] + ["--outdir", outdir]))


def main():
    case, workdir = sys.argv[1], sys.argv[2]
    torch.set_num_threads(2)
    inputs = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)[case]
    if case == "cli":  # the CLI makes its process group itself
        out = case_cli(inputs)
    else:
        dp, _ = init_from_env("cpu")
        try:
            out = {"two": case_two, "nodes": case_nodes, "flagship_nodes": case_flagship_nodes}[case](dp, inputs)
        finally:
            dp.close()
    torch.save(out, os.path.join(workdir, f"{case}_rank{os.environ['RANK']}.pt"))


if __name__ == "__main__":
    main()
