"""The port's training sampler and batch plans against the JAX package's,
and the `$BFM_PATH` repair of `PutRoiFromLandmarks`.

 - The index stream of `make_concat_dataset_item_sampler` (pseudo-random
   dataset choice) and of a `ConcatDatasetSampler` over `SobolChoices` is
   identical to the JAX package's for the same seeds and weights.
 - `plan_batches` gives the JAX loader's `FusedBatchLoader.plan_batches`
   plans (indices, tag ids, weights) for single frames and for sequences.
 - `iterate_fused_batches(..., start=s)` gives the batches a fresh iterator
   of an equal sampler gives after s batches.
 - With `extend_to_forehead` and `$BFM_PATH` naming a 3DDFA pickle (a
   synthetic one), the box is the posed full mesh's, equal to the JAX
   transform's; without it the head-sphere box is the JAX package's.
"""

import itertools

import numpy as np
import pytest
import torch

from neuralnet_tracker_traincode_tpu.data import sampling as JS
from neuralnet_tracker_traincode_tpu.data.batch import Batch as JBatch, Metadata as JMetadata
from neuralnet_tracker_traincode_tpu.data.fields import Tag as JTag
from neuralnet_tracker_traincode_tpu.data.host_transforms import PutRoiFromLandmarks as JPut
from neuralnet_tracker_traincode_tpu.data.loader import FusedBatchLoader
from neuralnet_tracker_traincode_torch import utils
from neuralnet_tracker_traincode_torch.data import sampling as TS
from neuralnet_tracker_traincode_torch.data.batch import frame
from neuralnet_tracker_traincode_torch.data.fields import Tag
from neuralnet_tracker_traincode_torch.data.host_transforms import PutRoiFromLandmarks
from neuralnet_tracker_traincode_torch.data.loader import iterate_fused_batches, pack_fused_batch, plan_batches

SIZES = (5, 11, 3)
WEIGHTS = (1.0, 3.0, 0.5)


def _datasets(S):
    return S.ConcatDataset([list(range(n)) for n in SIZES])


@pytest.mark.parametrize("seed", [0, 7, 1234])
def test_item_sampler_stream_is_the_jax_one(seed):
    ref = JS.make_concat_dataset_item_sampler(_datasets(JS), WEIGHTS, seed=seed)
    out = TS.make_concat_dataset_item_sampler(_datasets(TS), WEIGHTS, seed=seed)
    want = list(itertools.islice(iter(ref), 200))
    assert list(itertools.islice(iter(out), 200)) == want
    assert sorted(set(want)) == list(range(sum(SIZES)))  # every dataset is drawn from
    # a second iteration continues the per-dataset permutations, as in the JAX package
    assert list(itertools.islice(iter(out), 50)) == list(itertools.islice(iter(ref), 50))


@pytest.mark.parametrize("seed", [3, 11])
def test_sobol_choice_stream_is_the_jax_one(seed):
    def sampler(S):
        ds = _datasets(S)
        wrapped = [S.RandomSampler(d, seed=seed + i) for i, d in enumerate(ds.datasets)]
        return S.ConcatDatasetSampler(ds, wrapped, S.SobolChoices(WEIGHTS, seed=seed), stop_after=64)

    ref, out = list(sampler(JS)), list(sampler(TS))
    assert out == ref and len(out) == 64
    choices = [TS.SobolChoices(WEIGHTS, seed=seed)() for _ in range(3)]
    assert all(0 <= c < len(WEIGHTS) for c in choices)


def test_subset_and_transformed_datasets_match_jax():
    for S in (JS, TS):
        ds = S.TransformedDataset(S.Subset(list(range(10, 20)), [3, 1, 4]), lambda v: v * 2)
        assert len(ds) == 3 and [ds[i] for i in range(3)] == [26, 22, 28]
    assert TS.weights_normalized([1, 3]).tolist() == JS.weights_normalized([1, 3]).tolist()
    with pytest.raises(ValueError, match="empty"):
        next(utils.cycle([]))


_TAGS = (JTag.POSE_WITH_LANDMARKS, JTag.ONLY_POSE, JTag.FACE_DETECTION)


@pytest.mark.parametrize("batchsize", [4, 7])
def test_plan_batches_are_the_jax_plans(batchsize):
    tag_to_id = {tag: i for i, tag in enumerate(_TAGS)}
    jds = _datasets(JS)
    loader = FusedBatchLoader(
        jds, lambda i: _TAGS[i], tag_to_id, JS.make_concat_dataset_item_sampler(jds, WEIGHTS, seed=5, stop_after=45),
        batchsize, pad_size=64, dataset_weight_by_index=lambda i: [1.0, 0.5, 2.0][i],
    )
    ref = [tuple(p) for p in loader.plan_batches()]
    port_tags = (Tag.POSE_WITH_LANDMARKS, Tag.ONLY_POSE, Tag.FACE_DETECTION)
    tds = _datasets(TS)
    out = plan_batches(
        tds, lambda i: port_tags[i], {tag: i for i, tag in enumerate(port_tags)},
        TS.make_concat_dataset_item_sampler(tds, WEIGHTS, seed=5, stop_after=45), batchsize,
        dataset_weight_by_index=lambda i: [1.0, 0.5, 2.0][i],
    )
    assert [tuple(p) for p in out] == ref
    assert len(ref) == -(-45 // batchsize) and len(ref[-1][0]) == 45 - (len(ref) - 1) * batchsize


def test_plan_batches_of_sequences_wait_for_the_loader():
    """Sequences (here of 2 or 3 frames, through a Subset) plan as the JAX
    loader plans them: a sequence that would overflow a plan opens the next."""

    def sequences(S):
        class Sequences(list):
            def sequence_frame_count(self, index):
                return 2 + index % 2

        return S.ConcatDataset([S.Subset(Sequences(range(6)), [0, 1, 3, 4, 5]), list(range(3))])

    jds = sequences(JS)
    loader = FusedBatchLoader(jds, lambda i: _TAGS[i], {t: i for i, t in enumerate(_TAGS)},
                              JS.make_concat_dataset_item_sampler(jds, [2.0, 1.0], seed=4, stop_after=30), 5, 64)
    ref = [tuple(p) for p in loader.plan_batches()]
    tds = sequences(TS)
    port_tags = (Tag.POSE_WITH_LANDMARKS, Tag.ONLY_POSE)
    out = [tuple(p) for p in plan_batches(tds, lambda i: port_tags[i], {t: i for i, t in enumerate(port_tags)},
                                          TS.make_concat_dataset_item_sampler(tds, [2.0, 1.0], seed=4, stop_after=30),
                                          5)]
    assert out == ref and len(out) > 8


def _frames(n, seed):
    rng = np.random.RandomState(seed)
    return [frame(Tag.FACE_DETECTION, dict(image=rng.randint(0, 256, (8, 8, 1), np.uint8),
                                           roi=np.float32([1, 1, 6, 6]), hasface=np.asarray(i % 2 == 0)))
            for i in range(n)]


@pytest.mark.parametrize("start", [0, 1, 5, 13])
def test_iterate_fused_batches_resumes_on_the_same_stream(start):
    """The batches follow the sampler's stream, cut at the batch size (the
    passes of 9 frames cross batches of 4), and a resumed iterator skips
    `start` x 4 indices of an equal stream."""
    frames = _frames(9, 2)
    packed = pack_fused_batch(frames, [0] * 9, 8)
    packed["coord_convention_id"] = np.arange(9, dtype=np.int32)

    def sampler():
        return TS.make_concat_dataset_item_sampler(TS.ConcatDataset([frames]), [1.0], seed=6)

    stream = list(itertools.islice(iter(JS.make_concat_dataset_item_sampler(JS.ConcatDataset([frames]), [1.0], seed=6)),
                                   4 * (start + 3)))
    resumed = iterate_fused_batches(packed, 4, sampler(), device="cpu", start=start)
    for b in range(3):
        got = next(resumed)
        want = stream[4 * (start + b): 4 * (start + b + 1)]
        assert got["coord_convention_id"].tolist() == want
        assert torch.equal(got["image"], torch.from_numpy(packed["image"][want]))
        assert got["param_index"].tolist() == [0, 1, 2, 3]


def _pose_frame(rng):
    lm = np.concatenate([40 + 30 * rng.rand(68, 2), rng.rand(68, 1)], -1).astype(np.float32)
    return dict(image=np.zeros((100, 100, 1), np.uint8), pt3d_68=lm,
                coord=np.float32([55.0, 50.0, 28.0]), pose=np.float32([0, 0, 0, 1]))


def test_bfm_path_with_forehead_box_is_not_ported(tmp_path, monkeypatch):
    """(The name is that of the refusal this test held before the full face
    model was ported.) With `$BFM_PATH`: the posed full mesh's box, equal to
    the JAX transform's, with and without a `shapeparam` label."""
    from scipy.spatial.transform import Rotation

    from torch_port_helpers import write_synthetic_bfm_pickle

    monkeypatch.setenv("BFM_PATH", write_synthetic_bfm_pickle(tmp_path / "bfm.pkl"))
    rng = np.random.RandomState(1)
    for with_shape in (True, False):
        fields = _pose_frame(rng)
        fields["pose"] = Rotation.random(random_state=rng).as_quat().astype(np.float32)
        if with_shape:
            fields["shapeparam"] = rng.randn(50).astype(np.float32)
        out = PutRoiFromLandmarks(extend_to_forehead=True)(frame(Tag.POSE_WITH_LANDMARKS, fields))
        ref = JPut(extend_to_forehead=True)(JBatch(JMetadata((100, 100), 0, categories={}),
                                                    **{k: v.copy() for k, v in fields.items()}))
        np.testing.assert_array_equal(out["roi"], ref["roi"])
        assert out["roi"].dtype == np.float32
    unposed = PutRoiFromLandmarks(extend_to_forehead=False)(frame(Tag.POSE_WITH_LANDMARKS, fields))
    np.testing.assert_array_equal(unposed["roi"], np.concatenate([fields["pt3d_68"][:, :2].min(0),
                                                                  fields["pt3d_68"][:, :2].max(0)]))
    monkeypatch.setenv("BFM_PATH", str(tmp_path / "missing.pkl"))
    PutRoiFromLandmarks(extend_to_forehead=True)  # a path that names no file is the head sphere
    monkeypatch.delenv("BFM_PATH")
    fields = _pose_frame(np.random.RandomState(0))
    out = PutRoiFromLandmarks(extend_to_forehead=True)(frame(Tag.POSE_WITH_LANDMARKS, fields))
    ref = JPut(extend_to_forehead=True)(JBatch(JMetadata((100, 100), 0, categories={}), **{k: v.copy() for k, v in fields.items()}))
    np.testing.assert_array_equal(out["roi"], ref["roi"])
    c, s = fields["coord"][:2], fields["coord"][2]
    np.testing.assert_allclose(out["roi"], np.concatenate([np.minimum(fields["pt3d_68"][:, :2].min(0), c - s),
                                                          np.maximum(fields["pt3d_68"][:, :2].max(0), c + s)]))
