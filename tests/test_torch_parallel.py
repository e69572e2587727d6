"""Data-parallel training of the port (`parallel/distributed.py`) on the CPU
with gloo, against one process on the whole batch and against the JAX
package (`parallel/mesh.py`, its step on the 8-device CPU mesh).

The ranks run in subprocesses (`tests/torch_dp_worker.py`, launched as
`tests/test_multihost.py` launches its workers: a free port, `torchrun`'s
variables, a timeout of their own); this process computes the references
meanwhile.

 - `process_local_seed` and the rows of each rank are `mesh.py`'s.
 - `draws_for_rows`: each rank's draws on its rows give the rows of the
   whole batch's augmentation, bit for bit (sequences across the edge too);
   `_produce_rows` gives the rows of the JAX loader's batches.
 - Two ranks (one launch): synchronized BatchNorm with 3 rows and 1 row
   within 1e-6 of one process on the 4 rows and of flax's BatchNorm (the
   biased running variance); K1's plan of two ranks with different ROIs is
   the larger one on both; the loader's rows and agreed padding; the
   flagship step at widen 0.25, 2 ranks x 4 rows, 2 steps with the JAX
   package's draws of the 8 rows: the ranks bit-equal, the first step's
   metrics within 1e-5 of the port's one process on the 8 rows and its
   moments within the f32 floor of another order of reductions, and within
   `tests/test_torch_train_step.py`'s tolerances of the JAX package's
   `train_step` on the 8-device mesh; a K = 2 block with image augmentation
   and a sequence across the ranks' edge; the device part reads nothing
   back; efficientnet_b0 (stochastic depth, masks
   per rank) bit-equal across ranks after 2 steps.
 - Four ranks as 2 nodes x 2: each node's plans are the JAX loader's for
   that node's `process_local_seed`, each rank's batches their rows; the
   flagship step (2 steps, each node's batch of 8 in its own row numbers,
   the draws of the 16 rows given): the 4 ranks bit-equal, the first step's
   state within the CLI test's limits of one process on the 16 rows.
 - The training CLI under `torchrun`'s variables, 2 ranks, one epoch: only
   rank 0 writes files, and its `last.ckpt` is within 1e-5 of one process's.
   2 ranks with one shared output directory, resumed after epoch 1: every
   file bit-equal to an uninterrupted 2-rank run's.
"""

import itertools
import os
import socket
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

from neuralnet_tracker_traincode_tpu.augmentation.pipeline import TrainAugmentationConfig as JCfg
from neuralnet_tracker_traincode_tpu.data.loader import LABEL_CATEGORIES as JCATS
from neuralnet_tracker_traincode_tpu.parallel import mesh as jmesh
from neuralnet_tracker_traincode_tpu.train.loop import PoseTrainer as JTrainer, TrainerConfig as JTrainerConfig
from neuralnet_tracker_traincode_torch.augmentation.pipeline import (
    TrainAugmentationConfig as TCfg,
    augment_batch_for_training,
    draws_for_rows,
    sample_augmentation_parameters,
)
from neuralnet_tracker_traincode_torch.data.loader import LABEL_CATEGORIES as TCATS
from neuralnet_tracker_traincode_torch.models.backbones.common import BatchNorm2d
from neuralnet_tracker_traincode_torch.models.weights import posenet_state_dict_from_jax
from neuralnet_tracker_traincode_torch.parallel.distributed import local_rows, process_local_seed
from neuralnet_tracker_traincode_torch.train.loop import PoseTrainer as TTrainer, TrainerConfig as TTrainerConfig
from test_torch_train_step import _check_step
from torch_port_helpers import (  # noqa: F401 - two_intra_op_threads is autouse
    LABEL_KEYS,
    SMALL_NET,
    flagship_criteria,
    jax_augmentation_draws,
    leaf_rel_err,
    make_batch,
    two_intra_op_threads,
    write_random_pose_file,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_dp_worker.py")
B = 8
TABLE = [1.0, 0.5, 0.25, 2.0]
GEOMETRY = dict(inputsize=129, enable_image_aug=False, p_flip_rot90=0.5)  # test_torch_train_step's _AUG
FULL = dict(inputsize=129, enable_image_aug=True, p_flip_rot90=0.5)
COMMON = dict(batchsize=B, lr=1e-3, epochs=4, samples_per_epoch=4 * B)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(case: str, workdir: str, ranks: int, local_ranks: int):
    port = _free_port()
    procs = []
    for r in range(ranks):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(ranks), LOCAL_RANK=str(r % local_ranks),
                   LOCAL_WORLD_SIZE=str(local_ranks), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="2")
        procs.append(subprocess.Popen([sys.executable, WORKER, case, workdir], env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    return procs


def _finish(procs, what: str, timeout: float = 300):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"{what}: process {i} failed:\n{out[-4000:]}"


def _results(case: str, workdir: str, ranks: int):
    return [torch.load(os.path.join(workdir, f"{case}_rank{r}.pt"), weights_only=False) for r in range(ranks)]


def _bit_equal(a, b, what):
    """Every tensor of two nested dicts/lists bit-equal."""
    if isinstance(a, dict):
        assert set(a) == set(b), what
        for k in a:
            _bit_equal(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)):
        for i, (x, y) in enumerate(zip(a, b)):
            _bit_equal(x, y, f"{what}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), what
    else:
        assert a == b, what


def _close(got, want, what, tol=1e-5):
    """Each tensor of `want` within `tol` of `got`'s, relative above 1."""
    for k in want:
        np.testing.assert_allclose(got[k].double().numpy(), want[k].double().numpy(), rtol=tol, atol=tol,
                                   err_msg=f"{what} {k}")


# ---- no processes ------------------------------------------------------------------

@pytest.mark.parametrize("seed", [None, 0, 7, 123456789])
@pytest.mark.parametrize("nodes", [1, 2, 5])
def test_process_local_seed_and_rows_are_the_mesh_ones(monkeypatch, seed, nodes):
    """`mesh.process_local_seed` with the node as the process index; each
    rank's rows are its device's shard of a batch over a `ranks`-device mesh."""
    monkeypatch.setattr(jax, "process_count", lambda: nodes)
    for node in range(nodes):
        monkeypatch.setattr(jax, "process_index", lambda node=node: node)
        assert process_local_seed(seed, node, nodes) == jmesh.process_local_seed(seed)
    ranks = min(nodes + 1, 4)
    mesh = jmesh.make_mesh(jax.devices()[:ranks])
    shards = jmesh.batch_sharding(mesh).devices_indices_map((4 * ranks, 3))
    for r, d in enumerate(mesh.devices):
        assert shards[d][0] == local_rows(4 * ranks, r, ranks)
    with pytest.raises(ValueError):
        local_rows(10, 0, 4)


def test_draws_for_rows_give_the_rows_of_the_whole_batch():
    """Every stage on: the ROI, flip/rot90, stage-1 (masks and values on
    axis 1, one `perm`) and noise draws of the whole batch, resolved for each
    half with a sequence across the halves' edge, augment each half as the
    whole batch augments its rows, bit for bit."""
    rng = np.random.RandomState(2)
    batch = make_batch(rng, B, 96)
    batch["param_index"] = np.asarray([0, 0, 2, 3, 3, 3, 6, 7], np.int32)
    cfg = TCfg(**FULL)
    draws = sample_augmentation_parameters(torch.Generator().manual_seed(4), B, cfg)
    labels = {k: batch[k] for k in LABEL_KEYS}
    whole, whole_labels = augment_batch_for_training(batch["image"], labels, TCATS, cfg, params=draws,
                                                     param_index=batch["param_index"], device="cpu")
    for r in range(2):
        rows = local_rows(B, r, 2)
        mine = draws_for_rows(draws, rows, torch.from_numpy(batch["param_index"][rows]))
        assert torch.equal(mine.stage1.perm, draws.stage1.perm) and mine.stage1.masks.shape == (6, B // 2)
        assert torch.equal(mine.noise.seeds, draws.noise.seeds[rows])
        x, lab = augment_batch_for_training(batch["image"][rows], {k: v[rows] for k, v in labels.items()}, TCATS, cfg,
                                            params=mine, device="cpu")
        assert torch.equal(x, whole[rows])
        for k in lab:
            assert torch.equal(lab[k], whole_labels[k][rows]), k


def test_produce_rows_are_the_rows_of_the_jax_batches(tmp_path):
    """Each rank's rows of a plan (`_produce_rows`) against the JAX loader's
    batch of that plan: sequences across the ranks' edge, carried ones, the
    short last batch's fill and grown padding; `param_index` in the batch's
    row numbers; the image beyond the JAX batch's padding zero."""
    from neuralnet_tracker_traincode_tpu.data import loader as JL
    from neuralnet_tracker_traincode_tpu.data import pose_dataset as JP
    from neuralnet_tracker_traincode_tpu.data import sampling as JS
    from neuralnet_tracker_traincode_tpu.data.fields import Tag as JTag
    from neuralnet_tracker_traincode_torch.data import loader as TL
    from neuralnet_tracker_traincode_torch.data import pose_dataset as TP
    from neuralnet_tracker_traincode_torch.data import sampling as TS
    from neuralnet_tracker_traincode_torch.data.fields import Tag
    from torch_port_helpers import JaxVideoDataset

    video = write_random_pose_file(tmp_path / "video.h5", 16, seed=4, sequence_starts=[0, 3, 4, 9, 16])
    big = write_random_pose_file(tmp_path / "big.h5", 10, seed=3, big=(2, 7))
    port = TS.ConcatDataset([TP.Hdf5PoseVideoDataset(video, 2, 4, dataclass=Tag.POSE_WITH_LANDMARKS),
                             TP.Hdf5PoseDataset(big, dataclass=Tag.ONLY_POSE)])
    jds = JS.ConcatDataset([JaxVideoDataset(video, 2, 4, dataclass=JTag.POSE_WITH_LANDMARKS),
                            JP.Hdf5PoseDataset(big, dataclass=JTag.ONLY_POSE)])
    jtags = (JTag.POSE_WITH_LANDMARKS, JTag.ONLY_POSE)

    def jloader():  # each with a sampler of its own: a second pass of one sampler is another stream
        sampler = JS.make_concat_dataset_item_sampler(jds, [0.7, 0.3], stop_after=30, seed=5)
        return JL.FusedBatchLoader(jds, jtags.__getitem__, {t: i for i, t in enumerate(jtags)}, sampler, B, 64,
                                   num_workers=1)

    crossing = 0
    for plan, want in zip(jloader().plan_batches(), iter(jloader())):
        pad = want["image"].shape[1]
        for r in range(2):
            rows = local_rows(B, r, 2)
            got = TL._produce_rows(port, TL.BatchPlan(*plan), B, 64, 1, rows)
            assert set(got) == set(want)
            image = got.pop("image")
            assert image.shape[1] <= pad  # the ranks agree on the largest padding (`_agreed_padding`)
            padded = np.zeros_like(want["image"][rows])
            padded[:, : image.shape[1], : image.shape[2]] = image
            np.testing.assert_array_equal(padded, want["image"][rows])
            for k in got:
                np.testing.assert_array_equal(got[k], want[k][rows], err_msg=k)
            crossing += r == 1 and bool((got["param_index"] < B // 2).any())
    assert crossing > 0  # some sequence began in rank 0's rows and went on in rank 1's


def test_iterate_fused_batches_gives_each_rank_its_rows():
    """Frames held in memory (`iterate_fused_batches`, the library runs'
    batches): each rank's batches are its rows of the one-process batches
    from the same sampler stream, `param_index` in the batch's row numbers."""
    from neuralnet_tracker_traincode_torch.data.loader import iterate_fused_batches
    from neuralnet_tracker_traincode_torch.data.sampling import ConcatDataset, make_concat_dataset_item_sampler

    packed = make_batch(np.random.RandomState(6), 40, 32)

    def batches(rows=None):
        sampler = make_concat_dataset_item_sampler(ConcatDataset([list(range(40))]), [1.0], seed=2)
        return list(itertools.islice(iterate_fused_batches(packed, B, sampler, "cpu", start=1, rows=rows), 3))

    whole = batches()
    for r in range(2):
        rows = local_rows(B, r, 2)
        for got, want in zip(batches(rows), whole):
            assert set(got) == set(want)
            for k in want:
                assert torch.equal(got[k], want[k][rows]), k


# ---- two ranks ---------------------------------------------------------------------

def _jax_variables(seed: int = 4, noise: float = 0.05):
    """`torch_port_helpers.jax_posenet_variables(seed, **SMALL_NET)`, with
    the init jitted (the same values in a third of the time): the JAX
    network and its variables, noise added to every parameter and the
    BatchNorm statistics randomised."""
    from neuralnet_tracker_traincode_tpu.models.posenet import NetworkWithPointHead as JNet

    model = JNet(**SMALL_NET)
    x = jax.numpy.zeros((2, 129, 129, 1), jax.numpy.float32)
    cc = jax.numpy.zeros((2,), jax.numpy.int32)
    variables = jax.jit(lambda key: model.init(key, x, coord_convention_id=cc, train=False))(jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(lambda a: (np.asarray(a) + noise * rng.randn(*np.shape(a))).astype(np.float32),
                                    variables["params"])

    def stat(path, a):
        if getattr(path[-1], "key", "") == "var":
            return (0.5 + rng.rand(*np.shape(a))).astype(np.float32)
        return (0.1 * rng.randn(*np.shape(a))).astype(np.float32)

    return model, {"params": params, "batch_stats": jax.tree_util.tree_map_with_path(stat, variables["batch_stats"])}


def _jax_steps(jmodel, variables, batches, rng):
    """The JAX package's `train_step` on its 8-device CPU mesh over `batches`
    from `variables`: per step the references `_check_step` reads. The state
    is `init_state`'s without its (eager) network init."""
    from neuralnet_tracker_traincode_tpu.train.loop import TrainState as JState

    jcrit, _ = flagship_criteria()
    mesh = jmesh.make_mesh()
    assert mesh.devices.size == 8
    jtr = JTrainer(jmodel, jcrit, JTrainerConfig(aug=JCfg(**GEOMETRY), **COMMON), JCATS, lambda e: TABLE[e], mesh=mesh)
    params = jax.tree_util.tree_map(jax.numpy.asarray, variables["params"])
    stats = jax.tree_util.tree_map(jax.numpy.asarray, variables["batch_stats"])
    copy = lambda tree: jax.tree_util.tree_map(jax.numpy.copy, tree)  # noqa: E731
    zero = lambda: jax.numpy.zeros((), jax.numpy.int32)  # noqa: E731 - distinct buffers: the step donates them
    jstate = jax.device_put(JState(step=zero(), params=params, batch_stats=stats, opt_state=jtr.tx.init(params),
                                   swa_params=copy(params), swa_batch_stats=copy(stats), swa_count=zero()),
                            jmesh.replicated_sharding(mesh))

    def to_sd(params, stats):
        host = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
        return posenet_state_dict_from_jax({"params": host(params), "batch_stats": host(stats)}, SMALL_NET)

    from test_torch_train_step import _merge_masked

    out, old = [], to_sd(variables["params"], variables["batch_stats"])
    for batch in batches:
        jstate, jmetrics = jtr.train_step(jstate, jmesh.shard_batch(batch, mesh), jtr.weight_matrix(0), rng)
        adam = [jstate.opt_state[1].inner_states[g].inner_state[0] for g in ("main", "variance")]
        new = to_sd(jstate.params, jstate.batch_stats)
        out.append(dict(metrics={k: float(v) for k, v in jmetrics.items()}, new=new, old=old,
                        mu=to_sd(_merge_masked([a.mu for a in adam]), jstate.batch_stats),
                        nu=to_sd(_merge_masked([a.nu for a in adam]), jstate.batch_stats)))
        old = new
    return out


def _port_trainer(aug, state_dict, net=SMALL_NET):
    from neuralnet_tracker_traincode_torch.models.posenet import NetworkWithPointHead

    _, tcrit = flagship_criteria()
    model = NetworkWithPointHead(**net)
    tr = TTrainer(model, tcrit, TTrainerConfig(aug=TCfg(**aug), **COMMON), TCATS, lambda e: TABLE[e], device="cpu")
    return tr, tr.init_state(state_dict=state_dict)


def _snapshot(tr, state, metrics):
    clone = lambda tree: {k: v.detach().clone() for k, v in tree.items()}  # noqa: E731
    return dict(metrics=clone(metrics), model=clone(tr.model.state_dict()), mu=clone(state.opt_state.mu),
                nu=clone(state.opt_state.nu), count=int(state.opt_state.count), step=state.step)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Start the two ranks, compute the references meanwhile, and return
    (the ranks' results, the references)."""
    workdir = str(tmp_path_factory.mktemp("two_ranks"))
    rng = np.random.RandomState(0)
    bn = dict(x=rng.randn(4, 3, 5, 5).astype(np.float32) * 2 + 0.5, dy=rng.randn(4, 3, 5, 5).astype(np.float32),
              weight=(1 + 0.3 * rng.randn(3)).astype(np.float32), bias=(0.2 * rng.randn(3)).astype(np.float32),
              running_mean=(0.1 * rng.randn(3)).astype(np.float32),
              running_var=(0.5 + rng.rand(3)).astype(np.float32))
    plan_batch = make_batch(np.random.RandomState(5), B, 160)
    plan_batch["roi"][B // 2:, 2:] = plan_batch["roi"][B // 2:, :2] + 150.0  # rank 1's ROIs: 2-3x larger
    plan = dict(aug=dict(inputsize=129, enable_image_aug=False), batch=plan_batch,
                draws=sample_augmentation_parameters(torch.Generator().manual_seed(1), B, TCfg(inputsize=129)))
    loader_file = write_random_pose_file(tmp_path_factory.mktemp("big") / "big.h5", 24, seed=3, big=(2, 7))

    jmodel, variables = _jax_variables()
    state_dict = posenet_state_dict_from_jax(variables, SMALL_NET)
    batches = [make_batch(np.random.RandomState(4 + i), B, 160) for i in range(2)]
    rng_key = jax.random.PRNGKey(11)
    # the draws the JAX step makes at steps 0 and 1
    draws = [jax_augmentation_draws(jax.random.split(jax.random.fold_in(rng_key, s))[0], B, JCfg(**GEOMETRY))
             for s in range(2)]
    block = [make_batch(np.random.RandomState(20 + i), B, 96) for i in range(2)]
    for b in block:
        b["param_index"] = np.asarray([0, 0, 2, 3, 3, 3, 6, 7], np.int32)  # a sequence over both ranks' rows
    stacked = {k: np.stack([b[k] for b in block]) for k in block[0]}
    inputs = dict(bn=bn, plan=plan, loader=dict(file=loader_file),
                  step=dict(aug=GEOMETRY, state_dict=state_dict, batches=batches, draws=draws),
                  block=dict(aug=FULL, seed=5, stacked=stacked),
                  efficientnet=[make_batch(np.random.RandomState(30 + i), 4, 96) for i in range(2)])
    torch.save({"two": inputs}, os.path.join(workdir, "inputs.pt"))
    procs = _start("two", workdir, 2, 2)
    try:
        ref = {"jax": _jax_steps(jmodel, variables, batches, rng_key), "step": []}
        tr, state = _port_trainer(GEOMETRY, state_dict)
        W = tr.weight_matrix(0)
        for batch, d in zip(batches, draws):
            state, m = tr.train_step(state, batch, W, aug_params=d)
            ref["step"].append(_snapshot(tr, state, m))
        tr, state = _port_trainer(FULL, state_dict)
        state, m = tr.train_step_multi(state, stacked, W, generator=torch.Generator().manual_seed(5))
        ref["block"] = _snapshot(tr, state, m)
    finally:
        _finish(procs, "two ranks")
    return _results("two", workdir, 2), inputs, ref


def test_sync_batchnorm_is_one_batchnorm_over_the_ranks(two_ranks):
    """3 rows on rank 0, 1 on rank 1: the output, the input gradient, the
    weight and bias gradients summed over the ranks and the running
    statistics within 1e-6 of one process on the 4 rows; and of flax."""
    import flax.linen as fnn

    ranks, inputs, _ = two_ranks
    bn_in = inputs["bn"]
    one = BatchNorm2d(3)
    with torch.no_grad():
        for k in ("weight", "bias", "running_mean", "running_var"):
            getattr(one, k).copy_(torch.from_numpy(bn_in[k]))
    x = torch.from_numpy(bn_in["x"]).requires_grad_()
    y = one(x)
    (y * torch.from_numpy(bn_in["dy"])).sum().backward()
    got = {k: torch.cat([r["bn"][k] for r in ranks]) for k in ("y", "dx")}
    want = dict(y=y.detach(), dx=x.grad)
    for r in ranks:
        for k in ("running_mean", "running_var"):
            want[k], got[k] = getattr(one, k), r["bn"][k]
        for k in ("weight", "bias"):
            want["d" + k], got["d" + k] = getattr(one, k).grad, sum(rr["bn"]["d" + k] for rr in ranks)
        _close(got, want, "sync BatchNorm against one process", tol=1e-6)

    # flax: NHWC, momentum 0.9 of the old statistics, the biased variance
    layer = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = {"params": {"scale": bn_in["weight"], "bias": bn_in["bias"]},
                 "batch_stats": {"mean": bn_in["running_mean"], "var": bn_in["running_var"]}}
    nhwc = np.transpose(bn_in["x"], (0, 2, 3, 1))
    fy, mutated = layer.apply(variables, nhwc, mutable=["batch_stats"])
    grad = jax.grad(lambda x: (layer.apply(variables, x, mutable=["batch_stats"])[0]
                               * np.transpose(bn_in["dy"], (0, 2, 3, 1))).sum())(nhwc)
    flax = dict(y=np.transpose(np.asarray(fy), (0, 3, 1, 2)), dx=np.transpose(np.asarray(grad), (0, 3, 1, 2)),
                running_mean=np.asarray(mutated["batch_stats"]["mean"]),
                running_var=np.asarray(mutated["batch_stats"]["var"]))
    got["running_mean"], got["running_var"] = ranks[0]["bn"]["running_mean"], ranks[0]["bn"]["running_var"]
    _close(got, {k: torch.from_numpy(v) for k, v in flax.items()}, "sync BatchNorm against flax", tol=1e-6)
    unbiased = 0.9 * bn_in["running_var"] + 0.1 * bn_in["x"].var(axis=(0, 2, 3), ddof=1)  # torch's update
    assert np.abs(unbiased - got["running_var"].numpy()).min() > 1e-4


def test_ranks_agree_on_the_larger_k1_plan(two_ranks):
    ranks, _, _ = two_ranks
    own = [r["plan"]["own"] for r in ranks]
    assert own[1].taps_x > own[0].taps_x and own[1].taps_y > own[0].taps_y
    assert ranks[0]["plan"]["agreed"] == ranks[1]["plan"]["agreed"] == own[1]


def test_loader_gives_each_rank_its_rows_padded_alike(two_ranks):
    """The two ranks' batches are the rows of the one-process loader's
    batches over the same sampler stream, padding included (a batch with a
    2.2x image on one rank's rows grows both ranks' padding)."""
    from neuralnet_tracker_traincode_torch.data import pose_dataset as TP
    from neuralnet_tracker_traincode_torch.data.fields import Tag
    from neuralnet_tracker_traincode_torch.data.loader import FusedBatchLoader
    from neuralnet_tracker_traincode_torch.data.sampling import ConcatDataset, make_concat_dataset_item_sampler

    ranks, inputs, _ = two_ranks
    concat = ConcatDataset([TP.Hdf5PoseDataset(inputs["loader"]["file"], dataclass=Tag.POSE_WITH_LANDMARKS)])
    sampler = make_concat_dataset_item_sampler(concat, [1.0], stop_after=40, seed=3)
    want = list(FusedBatchLoader(concat, lambda i: Tag.POSE_WITH_LANDMARKS, {Tag.POSE_WITH_LANDMARKS: 0}, sampler,
                                 B, 64, num_workers=1))
    assert len(want) == 5
    grown_on_one_rank = 0  # batches whose large image lies in one rank's rows only
    for i, batch in enumerate(want):
        for r, rank in enumerate(ranks):
            rows = local_rows(B, r, 2)
            got = rank["loader"][i]
            assert set(got) == set(batch)
            for k in batch:
                np.testing.assert_array_equal(got[k], batch[k][rows], err_msg=f"batch {i} rank {r} {k}")
        large = [bool(batch["image"][local_rows(B, r, 2), 64:].any()) for r in range(2)]
        grown_on_one_rank += large[0] != large[1]
    assert grown_on_one_rank > 0


def _as_trainer(snap):
    """A step's snapshot as `_check_step` reads a trainer and its state."""
    from neuralnet_tracker_traincode_torch.models.posenet import NetworkWithPointHead

    model = NetworkWithPointHead(**SMALL_NET)
    model.load_state_dict(snap["model"])
    opt = types.SimpleNamespace(count=snap["count"], mu=snap["mu"], nu=snap["nu"])
    return types.SimpleNamespace(model=model, params=lambda: dict(model.named_parameters())), \
        types.SimpleNamespace(step=snap["step"], opt_state=opt)


def _first_step_within_the_f32_floor(two, one, lr=1e-3):
    """One step of two ranks against one process on the whole batch, which
    differ in the order of the reductions alone: the metrics within 1e-5
    (measured 3e-7) and each leaf of BatchNorm statistics within 1e-4, as
    `test_torch_train_step.py` holds them (measured 1.05e-5 at full width on
    `bn1.running_mean`, a mean of 0.01 over conv outputs of order 1); the
    first moment (0.1 x the gradient) within 1e-2 a leaf and 3e-3 over all
    leaves, nu within 2e-2 a leaf (measured 4e-3 on the worst leaf and
    1.2e-3 over all: the first layers' gradients amplify rounding, see
    `test_torch_train_step.py`); the parameters within 1e-5 wherever the
    first moment exceeds 3e-2 of its leaf's RMS (measured 5e-6), and
    elsewhere within 2 lr: Adam's first step moves an element whose
    gradient is rounding noise by lr of either sign."""
    _close(two["metrics"], one["metrics"], "metrics", tol=1e-5)
    for k, v in one["model"].items():
        if "running" in k:
            assert leaf_rel_err(two["model"][k].numpy(), v.numpy()) <= 1e-4, k
    for k, mu in one["mu"].items():
        assert leaf_rel_err(two["mu"][k].numpy(), mu.numpy()) <= 1e-2, k
        assert leaf_rel_err(two["nu"][k].numpy(), one["nu"][k].numpy()) <= 2e-2, k
        signal = mu.abs() > 3e-2 * mu.pow(2).mean().sqrt()
        moved = (two["model"][k] - one["model"][k]).abs()
        assert float((moved * signal).max()) <= 1e-5 and float(moved.max()) <= 2 * lr + 1e-6, k
    flat = lambda tree: np.concatenate([tree[k].numpy().ravel() for k in one["mu"]])  # noqa: E731
    assert leaf_rel_err(flat(two["mu"]), flat(one["mu"])) <= 3e-3


def test_flagship_step_over_two_ranks(two_ranks):
    """2 ranks x 4 rows, 2 steps, the JAX draws of the 8 rows. The ranks
    are bit-equal. The first step against one process on the 8 rows: within
    the f32 floor of another order of reductions
    (`_first_step_within_the_f32_floor`). Against the JAX package's
    `train_step` on its 8-device mesh: the first step within `test_torch_train_step`'s limits for each
    package on its own crop (metrics 1e-4, quatreg 1e-3; BatchNorm
    statistics 1e-4 a leaf; mu / nu 0.1 / 0.2 a leaf and 0.1 over all; the
    update's mean size and signs over the elements above each leaf's noise,
    as for the full loss setup there: one element of
    `dw5_1.bn_sep.weight` has a gradient of -2.2e-9 on two ranks and moves
    by 0.18 lr).
    The second step's metrics within 1e-2 of both (measured 1.3e-3: after
    one step the trajectories differ by those noise elements)."""
    ranks, inputs, ref = two_ranks
    _bit_equal(ranks[0]["step"], ranks[1]["step"], "rank 0 against rank 1")
    old = {k: v.clone() for k, v in inputs["step"]["state_dict"].items()}
    one, two = ref["step"][0], ranks[0]["step"][0]
    _first_step_within_the_f32_floor(two, one)
    ttr, tstate = _as_trainer(two)
    assert _check_step(ref["jax"][0], ttr, tstate, two["metrics"], old, mu_leaf=0.1, nu_leaf=0.2, sign_floor=True,
                       size_floor=True) <= 0.1
    second = ranks[0]["step"][1]
    assert second["count"] == 2
    for want in (ref["step"][1]["metrics"], ref["jax"][1]["metrics"]):
        for k, v in want.items():
            np.testing.assert_allclose(second["metrics"][k].item(), float(v), rtol=1e-2, err_msg=k)


def test_block_with_image_augmentation_over_two_ranks(two_ranks):
    """K = 2 steps with every augmentation stage drawn from one generator
    and a sequence across the ranks' edge: the ranks bit-equal; the first
    step's metrics within 1e-5 of one process on the 8 rows (the draws,
    crops and intensity stages are the whole batch's rows), the second's
    within 1e-2; the device part reads nothing back."""
    ranks, _, ref = two_ranks
    _bit_equal(ranks[0]["block"], ranks[1]["block"], "rank 0 against rank 1")
    got, want = ranks[0]["block"], ref["block"]
    assert got["count"] == want["count"] == 2 and got["metrics"]["loss"].shape == (2,)
    _close({k: v[0] for k, v in got["metrics"].items()}, {k: v[0] for k, v in want["metrics"].items()},
           "block step 1 metrics, two ranks against one process", tol=1e-5)
    _close({k: v[1] for k, v in got["metrics"].items()}, {k: v[1] for k, v in want["metrics"].items()},
           "block step 2 metrics, two ranks against one process", tol=1e-2)
    assert ranks[0]["read_backs"] == ranks[1]["read_backs"] == []


def test_efficientnet_ranks_stay_bit_equal(two_ranks):
    """Stochastic depth draws its masks per rank; the state stays one."""
    ranks, _, _ = two_ranks
    _bit_equal(ranks[0]["efficientnet"], ranks[1]["efficientnet"], "rank 0 against rank 1")
    assert ranks[0]["efficientnet"]["count"] == 2


# ---- four ranks as two nodes, and the CLI -------------------------------------------

@pytest.fixture(scope="module")
def datadir(tmp_path_factory):
    from neuralnet_tracker_traincode_torch.data.synthetic import write_synthetic_pose_dataset

    d = tmp_path_factory.mktemp("dp_datadir")
    write_synthetic_pose_dataset(str(d / "aflw2k.h5"), 20, 64, seed=4, device="cpu")
    write_synthetic_pose_dataset(str(d / "300wlp.h5"), 24, 64, seed=3, device="cpu")
    return str(d)


def test_two_nodes_sample_their_process_local_streams(datadir, tmp_path, monkeypatch):
    """Ranks 0-1 (node 0) and 2-3 (node 1): each node's plans are the JAX
    loader's in a process of index `node` of 2, and each rank's batches
    are its rows of that loader's batches."""
    from neuralnet_tracker_traincode_tpu import pipelines as JPL
    from neuralnet_tracker_traincode_tpu.data.fields import DatasetId as JId

    torch.save({"nodes": dict(datadir=datadir)}, tmp_path / "inputs.pt")
    procs = _start("nodes", str(tmp_path), 4, 2)
    try:
        monkeypatch.setenv("DATADIR", datadir)
        monkeypatch.setattr(jax, "process_count", lambda: 2)
        want = []
        for node in range(2):
            monkeypatch.setattr(jax, "process_index", lambda node=node: node)
            loader, *_ = JPL.make_pose_estimation_loaders(inputsize=129, batchsize=B, datasets=[JId._300WLP],
                                                          seed=11, num_workers=1)
            want.append(([tuple(p) for p in itertools.islice(loader.plan_batches(), 3)],
                         list(itertools.islice(iter(loader), 2))))
    finally:
        _finish(procs, "two nodes")
    ranks = _results("nodes", str(tmp_path), 4)
    assert want[0][0] != want[1][0]
    for r, got in enumerate(ranks):
        plans, batches = want[r // 2]
        assert got["plans"] == plans, r
        for i, batch in enumerate(batches):
            for k in batch:
                np.testing.assert_array_equal(got["batches"][i][k], batch[k][local_rows(B, r % 2, 2)],
                                              err_msg=f"rank {r} batch {i} {k}")


def _state_within_the_cli_limits(two, one, lr=1e-3):
    """One step of several ranks against one process on the same rows, at
    the limits `test_training_cli_over_two_ranks` sets out: each leaf of
    BatchNorm statistics within 1e-4, the first moment within 0.2 over all
    leaves, 95% of the parameters within 1e-5 and all within 2 lr."""
    assert two["count"] == one["count"] == 1
    for k, v in one["model"].items():
        if "running" in k:
            assert leaf_rel_err(two["model"][k].numpy(), v.numpy()) <= 1e-4, k
    flat = lambda tree: np.concatenate([tree[k].numpy().ravel() for k in one["mu"]])  # noqa: E731
    assert leaf_rel_err(flat(two["mu"]), flat(one["mu"])) <= 0.2
    moved = np.abs(flat(two["model"]) - flat(one["model"]))
    assert np.mean(moved <= 1e-5) >= 0.95 and moved.max() <= 2 * lr + 1e-6


def test_flagship_step_over_two_nodes_of_two_ranks(tmp_path):
    """Ranks 0-1 (node 0) and 2-3 (node 1), 4 rows each, 2 steps: each
    node's batch holds its 8 rows with `param_index` in its own row
    numbers, the draws are the 16 rows'. The 4 ranks are bit-equal after
    both steps; the first step against one process on the 16 rows within
    the CLI test's limits (`_state_within_the_cli_limits`) and its metrics
    within 1e-5, the second's metrics within 1e-2 (as for two ranks)."""
    from neuralnet_tracker_traincode_torch.models.posenet import NetworkWithPointHead

    n = 2 * B
    _, tcrit = flagship_criteria()
    one = TTrainer(NetworkWithPointHead(**SMALL_NET), tcrit, TTrainerConfig(aug=TCfg(**GEOMETRY), **COMMON), TCATS,
                   lambda e: TABLE[e], device="cpu")
    state = one.init_state(torch.Generator().manual_seed(0))
    state_dict = {k: v.clone() for k, v in one.model.state_dict().items()}
    batches = [make_batch(np.random.RandomState(40 + i), n, 160) for i in range(2)]
    draws = [sample_augmentation_parameters(torch.Generator().manual_seed(50 + i), n, TCfg(**GEOMETRY))
             for i in range(2)]
    node_rows = [dict(b, param_index=b["param_index"] % B) for b in batches]  # each node numbers its own rows
    torch.save({"flagship_nodes": dict(aug=GEOMETRY, state_dict=state_dict, batches=node_rows, draws=draws)},
               tmp_path / "inputs.pt")
    procs = _start("flagship_nodes", str(tmp_path), 4, 2)
    try:
        W, ref = one.weight_matrix(0), []
        for batch, d in zip(batches, draws):
            state, m = one.train_step(state, batch, W, aug_params=d)
            ref.append(_snapshot(one, state, m))
    finally:
        _finish(procs, "flagship step over two nodes")
    ranks = _results("flagship_nodes", str(tmp_path), 4)
    assert [r["node"] for r in ranks] == [0, 0, 1, 1]
    for r in range(1, 4):
        _bit_equal(ranks[0]["step"], ranks[r]["step"], f"rank 0 against rank {r}")
    first = ranks[0]["step"][0]
    _state_within_the_cli_limits(first, ref[0])
    _close(first["metrics"], ref[0]["metrics"], "first step's metrics, 2 x 2 ranks against one process", tol=1e-5)
    for k, v in ref[1]["metrics"].items():
        np.testing.assert_allclose(ranks[0]["step"][1]["metrics"][k].item(), v.item(), rtol=1e-2, err_msg=k)


def _resume_file(path):
    """The model's state dict and Adam's moments of a `resume.pt`."""
    with open(path, "rb") as f:
        f.read(int.from_bytes(f.read(8), "little"))
        payload = torch.load(f, weights_only=True)
    return dict(model=payload["model"], mu=payload["adam"]["mu"], nu=payload["adam"]["nu"],
                count=payload["adam"]["count"])


def test_training_cli_over_two_ranks(datadir, tmp_path):
    """`train_poseestimator` under `torchrun`'s variables, 2 gloo ranks of 4
    rows, one epoch of one step, beside one process on the batch of 8: rank
    0 writes the files (the loss plot too), rank 1 none, and its `last.ckpt` holds the weights
    of its `resume.pt`. That state against the one process's, at the f32
    floor of another order of reductions at full width, where a permutation
    of one process's rows moves `bn1.weight`'s gradient by 16%: each leaf of
    BatchNorm statistics within 1e-4 (the forward of the whole batch); the
    first moment within 0.2 over all leaves (measured 7.3e-2; a gradient not
    averaged over the ranks reads 1); 95% of the parameters within 1e-5
    (measured 98.4%) and all within 2 lr (Adam's first step moves an element
    whose gradient is noise by lr of either sign)."""
    from neuralnet_tracker_traincode_torch.models.io import load_posenet

    argv = ["--ds", "300wlp", "--batchsize", "8", "--samples-per-epoch", "8", "--device", "cpu", "--dtype",
            "float32", "--seed", "0", "--epochs", "1"]
    out = str(tmp_path / "out")
    torch.save({"cli": dict(datadir=datadir, argv=argv, outdir=out + "/rank%d")}, tmp_path / "inputs.pt")
    procs = _start("cli", str(tmp_path), 2, 2)
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE")}
    env.update(DATADIR=datadir, NUM_WORKERS="1", OMP_NUM_THREADS="2")
    procs.append(subprocess.Popen(
        [sys.executable, "-m", "neuralnet_tracker_traincode_torch.scripts.train_poseestimator", *argv, "--outdir",
         out + "/one"], cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    _finish(procs, "training CLI")
    name = "NetworkWithPointHead_mobilenetv1"
    assert sorted(os.listdir(os.path.join(out, "rank0", name))) == ["best.ckpt", "last.ckpt", "resume.pt", "train.pdf"]
    assert os.listdir(os.path.join(out, "rank1", name)) == []
    two, one = (_resume_file(os.path.join(out, d, name, "resume.pt")) for d in ("rank0", "one"))
    _state_within_the_cli_limits(two, one)
    ckpt = load_posenet(os.path.join(out, "rank0", name, "last.ckpt")).state_dict()
    _bit_equal({k: v for k, v in ckpt.items() if not k.endswith("num_batches_tracked")},  # not in the file
               {k: v for k, v in two["model"].items() if not k.endswith("num_batches_tracked")}, "last.ckpt")


def test_training_cli_over_two_ranks_resumes_in_one_outdir(datadir, tmp_path):
    """2 ranks sharing one `--outdir`, as the ranks of a machine under
    `torchrun` do: `--epochs 1`, then `--epochs 2 --resume auto` (every rank
    loads the `resume.pt` that rank 0 wrote), against `--epochs 2`
    uninterrupted; epochs of 2 steps. The model files are the same bytes,
    and the state files hold the same weights, Adam moments and count."""
    argv = ["--ds", "300wlp", "--batchsize", "8", "--samples-per-epoch", "16", "--device", "cpu", "--dtype",
            "float32", "--seed", "0"]
    name = "NetworkWithPointHead_mobilenetv1"

    def launch(work, epochs, out, resume=()):
        os.makedirs(work)
        torch.save({"cli": dict(datadir=datadir, argv=argv + ["--epochs", str(epochs), *resume], outdir=out)},
                   os.path.join(work, "inputs.pt"))
        return _start("cli", work, 2, 2)

    whole, parts = str(tmp_path / "whole"), str(tmp_path / "parts")
    _finish(launch(str(tmp_path / "w"), 2, whole) + launch(str(tmp_path / "p1"), 1, parts), "2-rank runs")
    _finish(launch(str(tmp_path / "p2"), 2, parts, ("--resume", "auto")), "resumed 2-rank run")
    for work in ("w", "p1", "p2"):
        assert [r["exit"] for r in _results("cli", str(tmp_path / work), 2)] == [0, 0], work
    files = sorted(os.listdir(os.path.join(whole, name)))
    assert files == sorted(os.listdir(os.path.join(parts, name))) == ["best.ckpt", "last.ckpt", "resume.pt",
                                                                      "train.pdf"]
    for f in ("best.ckpt", "last.ckpt"):
        with open(os.path.join(whole, name, f), "rb") as a, open(os.path.join(parts, name, f), "rb") as b:
            assert a.read() == b.read(), f
    got, want = (_resume_file(os.path.join(d, name, "resume.pt")) for d in (parts, whole))
    assert want["count"] == 4
    _bit_equal(got, want, "resume.pt of the resumed run against the uninterrupted one")
