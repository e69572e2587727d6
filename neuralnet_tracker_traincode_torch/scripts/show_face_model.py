"""The sheet of the deformable 68-keypoint face model as a PDF (counterpart
of the JAX package's `scripts/show_face_model.py`): for each of the 50
blend-shape basis vectors of `facemodel/bfm.py:BFMModel`, the keypoints with
the vector as arrows, front and profile. Host only, no device.

    python -m neuralnet_tracker_traincode_torch.scripts.show_face_model [--out face_model.pdf]
"""

import argparse
import sys

import numpy as np


def draw_face_model(keypts: np.ndarray, bases: np.ndarray):
    """The figure: keypoints (68, 3) and basis vectors (50, 68, 3)."""
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot

    xs, ys, zs = keypts.T
    fig, axes = pyplot.subplots(10, 10, figsize=(30, 32))
    axes = axes.ravel()
    for view, ax_slice in (("front", slice(0, None, 2)), ("profile", slice(1, None, 2))):
        for i, (ax, basevec) in enumerate(zip(axes[ax_slice], bases)):
            dxs, dys, dzs = basevec.T
            us, dus = (xs, dxs) if view == "front" else (zs, dzs)
            ax.scatter(us, -ys, s=3.0, c="k")
            ax.quiver(us, -ys, dus, -dys, scale=2.0, color="r")
            ax.set(xlim=(-1.0, 1.0), ylim=(-1.5, 0.5), title=f"basis {i} {view}")
            ax.xaxis.set_visible(False)
            ax.yaxis.set_visible(False)
    pyplot.tight_layout()
    return fig


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Draws the deformable face model's basis vectors")
    parser.add_argument("--out", default="face_model.pdf")
    args = parser.parse_args(argv)
    from matplotlib import pyplot

    from neuralnet_tracker_traincode_torch.facemodel.bfm import BFMModel

    bfm = BFMModel()
    fig = draw_face_model(np.asarray(bfm.keypts), np.asarray(bfm.scaled_bases))
    fig.savefig(args.out)
    pyplot.close(fig)
    print(f"Wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
