"""The comparison that decides `correct`: what the timed path produced,
against the plain reference run on the same inputs.

Training numbers, over the block the run trained first (K steps from the
initial state, through the timed path's own call and feed):
  loss    the worst step's |loss - reference| / |reference|; loss_median
          the median step's
  terms   the worst step's and term's |value - reference|, against the
          larger of the reference's |value| and the step's median |term|;
          terms_median the median over the steps of each step's worst term
  moment  Adam's first moment after the block (the clipped gradients as the
          optimizer holds them), by the worst parameter: the gap between the
          two norms, against the larger of the reference's norm and the
          median parameter's; moment_median the median parameter's gap
  second_median  Adam's second moment after the block, the median parameter's gap
  second_heads_angle  1 - cos of the angle between the two sides' second
          moments, the median over the heads' parameters (those outside the
          backbone, `convnet.`): a measure of direction, which the global
          clip's scale leaves alone, on parameters that the backbone's
          BatchNorm does not precede
  change  each parameter's change over the block, by the worst parameter
  bn      the BatchNorm running statistics after the block, the worst;
          bn_median the median statistic's
Parameters whose reference first moment is under a thousandth of the
median parameter's move by rounding alone; they are left out of the
moments and the change (`left_out` counts them).

Answers checked one by one:
  nonfinite  losses of the window's blocks that are not finite
"""

from typing import Dict, List

import torch

LEAVE_OUT = 1e-3
BACKBONE = "convnet."


def _norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in d.items()}


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], names: List[str]) -> Dict[str, float]:
    """|‖prog‖ - ‖ref‖| / max(‖ref‖, median ‖ref‖) for each of `names`."""
    p, r = _norms({n: prog[n] for n in names}), _norms({n: ref[n] for n in names})
    med = float(torch.tensor([r[n] for n in names], dtype=torch.float64).median())
    return {n: abs(p[n] - r[n]) / max(r[n], med, 1e-30) for n in names}


def leaf_angles(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], names: List[str]) -> Dict[str, float]:
    """1 - cos(prog, ref) for each of `names`, each taken as one vector."""
    out = {}
    for n in names:
        a, b = prog[n].double().flatten(), ref[n].double().flatten()
        out[n] = 1.0 - float(a @ b) / max(float(a.norm() * b.norm()), 1e-300)
    return out


def _worst(gaps: Dict[str, float]) -> float:
    return max(gaps.values())


def _median(gaps: Dict[str, float]) -> float:
    return float(torch.tensor(list(gaps.values()), dtype=torch.float64).median())


def training_numbers(prog_metrics: torch.Tensor, prog: Dict, ref_metrics: torch.Tensor, ref_state: Dict,
                     ref_mu: Dict, ref_nu: Dict, sd0: Dict) -> Dict[str, float]:
    """The numbers above from (K, 1 + terms) metrics of both sides, the
    program's state after the block (`program.state_tensors`), the
    reference's state dict and moments, and the initial state dict."""
    pm, rm = prog_metrics.double().cpu(), ref_metrics.double().cpu()
    loss_gaps = (pm[:, 0] - rm[:, 0]).abs() / rm[:, 0].abs()
    t_ref = rm[:, 1:].abs()
    scale = torch.maximum(t_ref, t_ref.median(dim=1, keepdim=True).values)
    term_gaps = (pm[:, 1:] - rm[:, 1:]).abs() / scale
    ref_mu = {k: v.cpu() for k, v in ref_mu.items()}
    mu_norms = _norms(ref_mu)
    med = float(torch.tensor(list(mu_norms.values()), dtype=torch.float64).median())
    kept = [n for n, v in mu_norms.items() if v >= LEAVE_OUT * med]
    change_p = {n: prog["state"][n] - sd0[n].float().cpu() for n in kept}
    change_r = {n: ref_state[n].float().cpu() - sd0[n].float().cpu() for n in kept}
    stats = [n for n in ref_state if n.endswith(("running_mean", "running_var"))]
    moment, change = leaf_gaps(prog["mu"], ref_mu, kept), leaf_gaps(change_p, change_r, kept)
    second = leaf_gaps(prog["nu"], {k: v.cpu() for k, v in ref_nu.items()}, kept)
    heads = [n for n in kept if not n.startswith(BACKBONE)]
    second_heads = leaf_angles(prog["nu"], {k: v.cpu() for k, v in ref_nu.items()}, heads) or {"": float("nan")}
    bn = leaf_gaps(prog["state"], {n: ref_state[n].float().cpu() for n in stats}, stats) if stats else {"": 0.0}
    return {
        "loss": float(loss_gaps.max()),
        "loss_median": float(loss_gaps.median()),
        "terms": float(term_gaps.max()),
        "terms_median": float(term_gaps.amax(dim=1).median()),
        "moment": _worst(moment),
        "moment_median": _median(moment),
        "second_median": _median(second),
        "second_heads_angle": _median(second_heads),
        "change": _worst(change),
        "bn": _worst(bn),
        "bn_median": _median(bn),
        "left_out": float(len(mu_norms) - len(kept)),
        "worst": {"moment": max(moment, key=moment.get), "change": max(change, key=change.get),
                  "bn": max(bn, key=bn.get)},
    }


def judged(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number with a limit at or under it (and finite)."""
    return all(k in numbers and numbers[k] == numbers[k] and numbers[k] <= v for k, v in limits.items())
