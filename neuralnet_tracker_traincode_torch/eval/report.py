"""The evaluation table of the JAX package's `scripts/evaluate_pose_network.py`
as a library: the ROI configurations, the table (github markdown or JSON,
the same strings as the JAX script's for the same rows), and one row of it
from a Predictor over a loader of samples (`add_report_row`, the body of the
script's `report()`). The CLI around it is
`scripts/evaluate_pose_network.py`.
"""

import json
import os
from collections import defaultdict
from os.path import commonprefix, relpath
from typing import Dict, List, Literal, NamedTuple, Optional

import numpy as np
import torch

from neuralnet_tracker_traincode_torch import utils
from neuralnet_tracker_traincode_torch.eval import metrics as M
from neuralnet_tracker_traincode_torch.eval.predictor import Predictor

# Kinect horizontal field of view (Biwi protocol).
BIWI_HORIZONTAL_FOV = 57.0

AlignmentScheme = Literal["perspective", "opal23", "none"]


class RoiConfig(NamedTuple):
    expansion_factor: float = 1.1
    center_crop: bool = False
    use_head_roi: bool = True

    def __str__(self):
        crop = ["ROI", "CC"][self.center_crop]
        return f'{"(H_roi)" if self.use_head_roi else "(F_roi)"}{crop}{self.expansion_factor:0.1f}'


comprehensive_roi_configs = [
    RoiConfig(*x)
    for x in [
        (1.2, False),
        (1.1, False),
        (1.0, False),
        (1.2, False, False),
        (1.1, False, False),
        (1.0, False, False),
    ]
]


class TableBuilder:
    data_name_table = {"aflw2k3d": "AFLW 2k 3d", "aflw2k3d_grimaces": "grimaces"}

    def __init__(self):
        self._header = [
            "Data", "Pitch°", "Yaw°", "Roll°", "Mean°", "Geodesic°", "XY%", "S%",
            "NME3d%", "NME2d%_30", "NME2d%_60", "NME2d%_90", "NME2d%_avg",
        ]
        self._entries_by_model = defaultdict(list)

    def add_row(self, model, data, euler_angles, geodesic, rmse_pos, rmse_size, unweighted_nme_3d, nme_2d,
                data_aux_string=None):
        unweighted_nme_3d = unweighted_nme_3d * 100 if unweighted_nme_3d is not None else "n/a"
        nme_vals = ["n/a"] * 4 if nme_2d is None else [x * 100 for x in nme_2d]
        data = self.data_name_table.get(data, data) + (data_aux_string or "")
        self._entries_by_model[model] += [
            [data] + list(euler_angles)
            + [float(np.average(euler_angles)), geodesic, rmse_pos, rmse_size, unweighted_nme_3d]
            + nme_vals
        ]

    def rows(self, model) -> List[list]:
        return self._entries_by_model[model]

    def build(self) -> str:
        try:
            import tabulate
        except ImportError:
            tabulate = None
        prefix = commonprefix(list(self._entries_by_model.keys()))
        nicer = {m: relpath(m, prefix) if prefix else m for m in self._entries_by_model}
        rows_out = []
        for model, rows in self._entries_by_model.items():
            rows_out.append(nicer[model])
            if tabulate is not None:
                rows_out += tabulate.tabulate(rows, self._header, tablefmt="github", floatfmt=".2f").splitlines()
            else:
                rows_out.append(" | ".join(self._header))
                for r in rows:
                    rows_out.append(" | ".join(f"{v:.2f}" if isinstance(v, float) else str(v) for v in r))
        return "\n".join(rows_out)

    def build_json(self) -> str:
        prefix = commonprefix(list(map(os.path.dirname, self._entries_by_model.keys())))

        def model_table(rows):
            by_header = defaultdict(list)
            for row in rows:
                for name, value in zip(self._header, row):
                    by_header[name].append(value)
            return by_header

        return json.dumps(
            {relpath(m, prefix) if prefix else m: model_table(rows) for m, rows in self._entries_by_model.items()},
            indent=2,
        )


def add_report_row(
    builder: TableBuilder,
    predictor: Predictor,
    loader,
    model: str,
    data: str,
    roi_config: RoiConfig = RoiConfig(),
    alignment: AlignmentScheme = "none",
    chunksize: int = 128,
    stage_ms=None,
    errors_out: Optional[Dict[str, Optional[np.ndarray]]] = None,
) -> list:
    """Evaluate `predictor` over the samples of `loader` (single-frame
    Batches with the ROI of `roi_config` already put, e.g. by
    `data/host_transforms.py`: the head ROI for `use_head_roi`, else the
    face ROI) and add the row to `builder` under `model`; returns the row.
    The predictor must crop at `roi_config`'s expansion factor, which the
    row reports. `stage_ms` goes to `Predictor.evaluate`. `errors_out`, where
    given, receives the per-sample errors the CLI's `--vis` sorts by: 'rot'
    (geodesic), 'size' and 'kpts' (NME3d, None without landmarks)."""
    if predictor.expansion_factor != roi_config.expansion_factor:
        raise ValueError(f"the predictor crops at expansion {predictor.expansion_factor}, the row reports {roi_config}")
    sample = next(iter(loader))
    S = predictor.net.input_resolution
    probe = predictor.net(torch.zeros((1, S, S, 1)))
    with_landmarks = "pt3d_68" in sample and "pt3d_68" in probe

    collection = {"pose_errs": M.NormalizedXYSError()}
    if alignment == "none":
        collection.update(geodesic_errs=M.GeodesicError(), euler_errs=M.EulerAngleErrors())
    else:
        collection.update(
            geodesic_errs=M.AlignedRotationErrorMetric("geo", alignment, BIWI_HORIZONTAL_FOV),
            euler_errs=M.AlignedRotationErrorMetric("euler", alignment, BIWI_HORIZONTAL_FOV),
        )
    if with_landmarks:
        collection.update(uw_nme_3d=M.UnweightedKptNME(), nme_2d=M.KptNME(dimensions=2))
    results = predictor.evaluate(M.MetricCollection(collection), loader, chunksize, stage_ms)

    poseerrs = np.asarray(results["pose_errs"])
    geodesic_errs = np.asarray(results["geodesic_errs"])
    eulererrs = np.asarray(results["euler_errs"])
    uw_nme_3d = np.asarray(results["uw_nme_3d"]) if with_landmarks else None
    nme_2d = results["nme_2d"] if with_landmarks else None

    e_posx, e_posy, e_size = poseerrs.T
    rmse_pos = np.sqrt(np.average(np.sum(np.square(np.vstack([e_posx, e_posy]).T), axis=1)))
    rmse_size = np.sqrt(np.average(np.square(e_size)))
    if errors_out is not None:
        errors_out.update(kpts=uw_nme_3d, rot=geodesic_errs, size=e_size)
    builder.add_row(
        model=model,
        data=data,
        euler_angles=(np.average(np.abs(eulererrs), axis=0) * utils.rad2deg).tolist(),
        geodesic=float(np.average(geodesic_errs) * utils.rad2deg),
        rmse_pos=float(rmse_pos * 100.0),
        rmse_size=float(rmse_size * 100.0),
        data_aux_string=" / " + str(roi_config),
        unweighted_nme_3d=float(np.average(uw_nme_3d)) if uw_nme_3d is not None else None,
        nme_2d=nme_2d,
    )
    return builder.rows(model)[-1]
