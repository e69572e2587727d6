"""The port's viewers and figures against the JAX package's, on the CPU:
`vis.py` (`draw_semseg_*` and `draw_prediction` bit-equal; `plot3dlandmarks`
and the paging browser `matplotlib_plot_iterable` under the Agg backend,
their artists' data equal), `scripts/show_train_test_splits.py`
(`iterate_samples` with the JAX script's draws injected: the labels in crop
pixels within 1e-3 px of the JAX script's, the images within one gray
level, since the crops of the two packages differ by up to 0.007 gray; the
`--outdir` CLI writing 32 PNGs, and its pager with `pyplot.show` patched to
a no-op showing the same images), `scripts/show_face_model.py` (the bases
within 1e-6 of the JAX package's, the figures' data equal) and
`train/plotting.py:TrainHistoryPlotter` (the JAX package's histories for the
same points, the PDF written).
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest

from neuralnet_tracker_traincode_torch import vis as T_vis
from neuralnet_tracker_traincode_tpu import vis as J_vis

from torch_port_helpers import jax_augmentation_draws, make_batch, two_intra_op_threads  # noqa: F401

matplotlib.use("Agg")
from matplotlib import pyplot  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@functools.cache
def _jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_semseg_colours_are_the_jax_ones():
    rng = np.random.RandomState(0)
    indices = rng.randint(0, 11, (24, 32, 1))
    np.testing.assert_array_equal(T_vis.draw_semseg_class_indices(indices), J_vis.draw_semseg_class_indices(indices))
    logits = np.log(np.random.RandomState(1).dirichlet(np.ones(11), (24, 32))).astype(np.float32)
    got = T_vis.draw_semseg_logits(logits)
    assert got.dtype == np.uint8 and got.shape == (24, 32, 3)
    np.testing.assert_array_equal(got, J_vis.draw_semseg_logits(logits))


def _sample_and_prediction(rng, size=96):
    batch = make_batch(rng, 2, size)
    gt = {k: batch[k][0] for k in ("image", "roi", "pt3d_68", "pose", "coord")}
    gt["hasface"] = np.float32(0.2)  # the no-face cross
    pred = {k: batch[k][1] for k in ("roi", "pt3d_68", "pose", "coord")}
    return gt, pred


def test_draw_prediction_is_the_jax_one():
    rng = np.random.RandomState(2)
    for gt, pred in [_sample_and_prediction(rng), (_sample_and_prediction(rng)[0], None)]:
        got = T_vis.draw_prediction((gt, pred))
        np.testing.assert_array_equal(got, J_vis.draw_prediction((gt, pred)))
        assert got.shape == (96, 96, 3) and got.std() > 0


def test_plot3dlandmarks_is_the_jax_one():
    keypts = np.random.RandomState(3).randn(68, 3)
    axes = []
    for module in (T_vis, J_vis):
        fig = pyplot.figure()
        ax = fig.add_subplot(projection="3d")
        module.plot3dlandmarks(ax, keypts)
        axes.append(ax)
    got, want = axes
    for g, w in zip(got.collections[0]._offsets3d, want.collections[0]._offsets3d):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert [t.get_text() for t in got.texts] == [t.get_text() for t in want.texts] == [str(i) for i in range(68)]
    assert (got.get_xlabel(), got.get_ylabel(), got.get_zlabel()) == ("X", "Y", "Z")
    for ax in axes:
        pyplot.close(ax.figure)


def _pages(fig):
    return [np.asarray(ax.get_images()[0].get_array()) for ax in fig.axes if ax.get_images()]


def test_the_pager_is_the_jax_one():
    """12 items: the first page shows 9; "Next" the last 3, and the panels
    after the first empty one keep the first page's images (as the JAX
    package's pager leaves them)."""
    images = [np.full((8, 8, 3), i * 20, np.uint8) for i in range(12)]
    shown = []
    for module in (T_vis, J_vis):
        fig, button = module.matplotlib_plot_iterable(iter(images), lambda im: im)
        first = _pages(fig)
        button._observers.process("clicked", None)
        shown.append((first, _pages(fig)))
        pyplot.close(fig)
    (first, second), (jfirst, jsecond) = shown
    assert len(first) == len(jfirst) == 9 and len(second) == len(jsecond) == 8
    for g, w in zip(first + second, jfirst + jsecond):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(second, images[9:] + images[4:9]):
        np.testing.assert_array_equal(g, w)


def _jax_iterate_samples(batches, jcfg, key):
    """The body of the JAX script's `iterate_samples` on the same batches."""
    from neuralnet_tracker_traincode_tpu.augmentation.affine import (
        position_unnormalization,
        transform_coord,
        transform_points,
        transform_roi,
    )
    from neuralnet_tracker_traincode_tpu.augmentation.pipeline import augment_batch_for_training
    from neuralnet_tracker_traincode_tpu.data.loader import LABEL_CATEGORIES

    for step, batch in enumerate(batches):
        labels = {k: jnp.asarray(v) for k, v in batch.items() if k in LABEL_CATEGORIES and k != "image"}
        x, out = augment_batch_for_training(jax.random.fold_in(key, step), jnp.asarray(batch["image"]), labels,
                                            LABEL_CATEGORIES, jcfg, param_index=jnp.asarray(batch["param_index"]))
        B = x.shape[0]
        un = position_unnormalization(x.shape[2], x.shape[1]).broadcast_to((B,))
        imgs = np.clip((np.asarray(x) + 0.5) * 255.0, 0, 255).astype(np.uint8)
        shown = {"pt3d_68": np.asarray(transform_points(un, out["pt3d_68"])),
                 "coord": np.asarray(transform_coord(un, out["coord"])),
                 "roi": np.asarray(transform_roi(un, out["roi"])), "pose": np.asarray(out["pose"])}
        for i in range(B):
            if batch["dataset_weight"][i]:
                yield {"image": imgs[i], **{k: v[i] for k, v in shown.items()}}, None


@pytest.mark.parametrize("image_aug", [False, True], ids=["geometry", "with_image_aug"])
def test_iterate_samples_with_injected_draws_is_the_jax_scripts(image_aug):
    """Two batches of 8 (a padding row in the second, which is skipped), the
    draws of the JAX script's `fold_in(key, step)` injected into the port.
    With image augmentation on, the two packages' noise comes from their own
    generators, so only the labels compare."""
    import torch

    from neuralnet_tracker_traincode_torch.augmentation.pipeline import TrainAugmentationConfig as TCfg
    from neuralnet_tracker_traincode_torch.scripts.show_train_test_splits import iterate_samples
    from neuralnet_tracker_traincode_tpu.augmentation.pipeline import TrainAugmentationConfig as JCfg

    rng = np.random.RandomState(5)
    batches = [make_batch(rng, 8, 96) for _ in range(2)]
    batches[1]["dataset_weight"][3] = 0.0
    kw = dict(inputsize=129, rotation_aug_angle=30.0, extension_factor=1.1, enable_image_aug=image_aug,
              p_flip_rot90=0.3)
    key = jax.random.PRNGKey(7)
    want = list(_jax_iterate_samples(batches, JCfg(**kw), key))

    def draws(step, B):
        return jax_augmentation_draws(jax.random.fold_in(key, step), B, JCfg(**kw))

    got = list(iterate_samples(batches, TCfg(**kw), torch.Generator().manual_seed(0), "cpu", draws=draws))
    assert len(got) == len(want) == 15
    for (g, g_pred), (w, _) in zip(got, want):
        assert g_pred is None and set(g) == set(w)
        for k in ("pt3d_68", "coord", "roi"):
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-3, err_msg=k)
        np.testing.assert_allclose(g["pose"], w["pose"], rtol=0, atol=1e-5)
        assert g["image"].shape == w["image"].shape == (129, 129, 1) and g["image"].dtype == np.uint8
        if not image_aug:
            assert np.abs(g["image"].astype(int) - w["image"]).max() <= 1


@pytest.fixture(scope="module")
def splits_datadir(tmp_path_factory):
    from neuralnet_tracker_traincode_tpu.data.synthetic import write_synthetic_pose_dataset

    d = tmp_path_factory.mktemp("splits_data")
    write_synthetic_pose_dataset(str(d / "300wlp.h5"), 24, 64, seed=6)
    write_synthetic_pose_dataset(str(d / "aflw2k.h5"), 8, 64, seed=7)  # the loaders' validation split
    return str(d)


def test_show_train_test_splits_cli_writes_32_samples_and_pages(splits_datadir, tmp_path, monkeypatch, capsys):
    """`--outdir`: 32 PNGs of the augmented samples (129 x 129, RGB). Without
    it, under Agg with `pyplot.show` a no-op, the pager's first page shows
    the first 9 of the same samples (the same seed draws the same)."""
    import cv2

    from neuralnet_tracker_traincode_torch.scripts import show_train_test_splits as cli

    monkeypatch.setenv("DATADIR", splits_datadir)
    monkeypatch.setenv("NUM_WORKERS", "1")
    argv = ["--ds", "300wlp", "--batchsize", "16", "--seed", "3", "--device", "cpu"]
    out = tmp_path / "png"
    assert cli.main(argv + ["--outdir", str(out)]) == 0
    assert sorted(os.listdir(out)) == [f"sample_{i:03d}.png" for i in range(32)]
    assert f"Wrote 32 augmented samples to {out}" in capsys.readouterr().out
    pngs = [cv2.imread(str(out / f"sample_{i:03d}.png"))[..., ::-1] for i in range(9)]
    assert all(p.shape == (129, 129, 3) for p in pngs)
    shown = []
    monkeypatch.setattr(pyplot, "show", lambda *a, **k: shown.append(pyplot.gcf()))
    assert cli.main(argv) == 0
    (fig,) = shown
    pages = _pages(fig)
    assert len(pages) == 9
    for page, png in zip(pages, pngs):
        np.testing.assert_array_equal(page, png)
    pyplot.close(fig)


def _figures_of(fn, monkeypatch):
    figs, subplots = [], pyplot.subplots

    def keep(*args, **kwargs):
        fig, axes = subplots(*args, **kwargs)
        figs.append(fig)
        return fig, axes

    monkeypatch.setattr(pyplot, "subplots", keep)
    fn()
    monkeypatch.setattr(pyplot, "subplots", subplots)
    return figs


def test_show_face_model_draws_the_jax_sheet(tmp_path, monkeypatch, capsys):
    import sys

    from neuralnet_tracker_traincode_torch.facemodel.bfm import BFMModel
    from neuralnet_tracker_traincode_torch.scripts import show_face_model as cli
    from neuralnet_tracker_traincode_tpu.facemodel.bfm import BFMModel as JBFMModel

    bases, jbases = BFMModel().scaled_bases, np.asarray(JBFMModel().scaled_bases)
    assert bases.shape == (50, 68, 3)
    np.testing.assert_allclose(bases, jbases, rtol=0, atol=1e-6)
    out, jout = str(tmp_path / "port.pdf"), str(tmp_path / "jax.pdf")
    (fig,) = _figures_of(lambda: cli.main(["--out", out]), monkeypatch)
    monkeypatch.setattr(sys, "argv", ["show_face_model.py", "--out", jout])
    (jfig,) = _figures_of(_jax_script("show_face_model").main, monkeypatch)
    assert f"Wrote {out}" in capsys.readouterr().out
    with open(out, "rb") as f:
        assert f.read(4) == b"%PDF"
    assert len(fig.axes) == len(jfig.axes) == 100
    for ax, jax_ in zip(fig.axes, jfig.axes):
        assert ax.get_title() == jax_.get_title()
        if not ax.collections:
            assert not jax_.collections  # the sheet's last panels stay empty
            continue
        points, arrows = ax.collections
        jpoints, jarrows = jax_.collections
        np.testing.assert_allclose(points.get_offsets(), jpoints.get_offsets(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(np.stack([arrows.U, arrows.V]), np.stack([jarrows.U, jarrows.V]), rtol=0, atol=1e-6)
    pyplot.close(fig)
    pyplot.close(jfig)


def test_train_history_plotter_keeps_the_jax_histories(tmp_path):
    from neuralnet_tracker_traincode_torch.train.plotting import TrainHistoryPlotter
    from neuralnet_tracker_traincode_tpu.train.plotting import TrainHistoryPlotter as JPlotter

    rng = np.random.RandomState(8)
    plotters = [TrainHistoryPlotter(str(tmp_path / "port.pdf")), JPlotter(str(tmp_path / "jax.pdf"))]
    for epoch in range(3):
        for step in range(4):
            for name in ("loss", "nll_rot", "pose"):
                value = float(rng.rand()) if (epoch, step) != (1, 2) else float("nan")
                for p in plotters:
                    p.add_train_point(epoch, epoch * 4 + step + 1, name, value)
        test = {"loss": rng.rand(), "pose": rng.rand(), "lr": 1e-3 * 0.5 ** epoch}
        for p in plotters:
            for name, value in test.items():
                p.add_test_point(epoch, name, value)
            p.summarize_train_values()
            p.update_graph()
    got, want = plotters
    assert list(got.histories) == list(want.histories) == ["loss", "nll_rot", "pose", "lr"]
    for name in want.histories:
        g, w = got.histories[name], want.histories[name]
        np.testing.assert_array_equal(np.asarray(g.train), np.asarray(w.train))
        assert [(e, float(v)) for e, v in g.test] == [(e, float(v)) for e, v in w.test]
        assert g.current_train_buffer == w.current_train_buffer == []
    got.close()
    with open(tmp_path / "port.pdf", "rb") as f:
        assert f.read(4) == b"%PDF"
