"""Multi-task / multi-dataset criterion.

Counterpart of the JAX package's `losses/criterion.py`: `Criterion` and
`CriterionGroup` with step-dependent weights, and `MaskedMultiTaskCriterion`,
which evaluates every loss term over the whole fused batch and masks it with
a per-sample weight looked up from a host-side (num_tags, num_terms) weight
matrix by the sample's tag id. Equal-but-distinct loss objects shared between
tags are deduplicated by `_loss_fingerprint` and evaluated once.
`compute_loss_of_batches` is the reference's loss over a list of per-tag
sub-batches, for the host and eval side.
"""

import functools
import types
from collections import defaultdict
from typing import Any, Callable, Dict, List, NamedTuple, Sequence, Union

import numpy as np
import torch


class LossVal(NamedTuple):
    val: Any  # per-sample loss values
    weight: Any  # scalar or per-sample weights
    name: str


class Criterion(NamedTuple):
    name: str
    f: Callable[[Dict, Dict], Any]
    w: Union[float, Callable[[int], float]]

    def evaluate(self, pred, batch, step) -> List[LossVal]:
        return [LossVal(self.f(pred, batch), self._eval_weight(step), self.name)]

    def _eval_weight(self, step):
        return self.w if isinstance(self.w, float) else self.w(step)


class CriterionGroup(NamedTuple):
    criterions: List[Union["CriterionGroup", Criterion]]
    name: str = ""
    w: Union[float, Callable[[int], float]] = 1.0

    def _eval_weight(self, step):
        return self.w if isinstance(self.w, float) else self.w(step)

    def evaluate(self, pred, batch, step) -> List[LossVal]:
        w = self._eval_weight(step)
        lossvals = sum((c.evaluate(pred, batch, step) for c in self.criterions), start=[])
        return [LossVal(v.val, v.weight * w, self.name + v.name) for v in lossvals]


def _full_like(w, val: torch.Tensor) -> torch.Tensor:
    """A per-sample weight tensor of `val`'s shape from a scalar or a tensor."""
    if tuple(getattr(w, "shape", ())) != ():
        return torch.as_tensor(w, device=val.device)
    return torch.full(val.shape, float(w), dtype=val.dtype, device=val.device)


def concatenated_lossvals_by_name(vals: Sequence[LossVal]) -> Dict[str, tuple]:
    """Group per-sub-batch LossVals by name: {name: (values, weights)}, each
    concatenated over the sub-batches, a scalar weight repeated per value."""
    value_lists, weight_lists = defaultdict(list), defaultdict(list)
    for v in vals:
        val = torch.atleast_1d(torch.as_tensor(v.val))
        value_lists[v.name].append(val)
        weight_lists[v.name].append(torch.atleast_1d(_full_like(v.weight, val)))
    return {k: (torch.cat(value_lists[k]), torch.cat(weight_lists[k])) for k in value_lists}


def compute_loss_of_batches(preds: Dict[str, Any], batches, step: int, loss):
    """The reference's loss over a list of per-tag sub-batches (`Batch`es
    whose predictions lie in `preds` one after the other): each sub-batch
    takes its rows of `preds` and its tag's criterion (`loss` a dict by tag,
    or one criterion), per-sample weights times its `dataset_weight` where
    it has one; the weighted values of all terms summed over the summed
    batch size. Returns (the loss, the LossVal list of each sub-batch)."""
    all_lossvals: List[List[LossVal]] = []
    offset = 0
    for subset in batches:
        (n,) = subset.meta.prefixshape
        subpreds = {k: v[offset:offset + n] if hasattr(v, "__getitem__") else v for k, v in preds.items()}
        loss_func = loss[subset.meta.tag] if isinstance(loss, dict) else loss
        terms = loss_func.evaluate(subpreds, subset, step)
        if "dataset_weight" in subset:
            dw = torch.as_tensor(subset["dataset_weight"])
            terms = [v._replace(weight=v.weight * dw) for v in terms]
        else:
            terms = [v._replace(weight=_full_like(v.weight, torch.atleast_1d(torch.as_tensor(v.val)))) for v in terms]
        all_lossvals.append(terms)
        offset += n
    batchsize = sum(max(s.meta.batchsize, 1) for s in batches)
    byname = concatenated_lossvals_by_name([v for terms in all_lossvals for v in terms])
    loss_sum = torch.cat([values * weights for values, weights in byname.values()]).sum() / batchsize
    return loss_sum, all_lossvals


class _Term(NamedTuple):
    name: str
    f: Callable


def _loss_fingerprint(f) -> tuple:
    """Semantic dedup key for a loss callable: (type, sorted simple attrs).

    Functions, lambdas, methods and partials keep identity semantics (two
    different lambdas must stay two terms); attributes that are not plain
    values (arrays, tables) fall back to identity.
    """
    if isinstance(f, (types.FunctionType, types.BuiltinFunctionType, types.MethodType, functools.partial)):
        return (f,)
    d = getattr(f, "__dict__", None)
    if d is None:
        return (f,)
    attrs = []
    for k, v in sorted(d.items()):
        if isinstance(v, (str, int, float, bool, type(None))):
            attrs.append((k, v))
        elif isinstance(v, (tuple, list)) and all(isinstance(x, (str, int, float, bool, type(None))) for x in v):
            attrs.append((k, tuple(v)))
        else:
            attrs.append((k, id(v)))
    return (type(f), tuple(attrs))


def _flatten_group(crit, prefix="", scale_fns=()):
    """Yield (name, f, composed_weight_fn) leaves of a criterion tree."""
    if isinstance(crit, Criterion):
        fns = scale_fns + (crit._eval_weight,)

        def weight_fn(step, fns=fns):
            w = 1.0
            for fn in fns:
                w = w * fn(step)
            return w

        yield (prefix + crit.name, crit.f, weight_fn)
    elif isinstance(crit, CriterionGroup):
        for c in crit.criterions:
            yield from _flatten_group(c, prefix + crit.name, scale_fns + (crit._eval_weight,))
    else:
        raise TypeError(type(crit))


class MaskedMultiTaskCriterion:
    """Fused-batch loss with per-tag masking.

    Build from a {tag: Criterion|CriterionGroup} dict plus the list of tags
    present in training (their order defines tag ids).
    """

    def __init__(self, crit_by_tag: Dict[Any, Union[Criterion, CriterionGroup]], tags: Sequence[Any]):
        self.tags = list(tags)
        self.tag_index = {t: i for i, t in enumerate(self.tags)}
        term_key_to_idx = {}
        self.terms: List[_Term] = []
        self.weight_fns: List[Dict[int, Callable]] = [dict() for _ in self.tags]
        for tag in self.tags:
            for name, f, weight_fn in _flatten_group(crit_by_tag[tag]):
                key = (name, _loss_fingerprint(f))
                if key not in term_key_to_idx:
                    term_key_to_idx[key] = len(self.terms)
                    self.terms.append(_Term(name, f))
                j = term_key_to_idx[key]
                ti = self.tag_index[tag]
                prev = self.weight_fns[ti].get(j)
                if prev is None:
                    self.weight_fns[ti][j] = weight_fn
                else:
                    self.weight_fns[ti][j] = lambda step, a=prev, b=weight_fn: a(step) + b(step)

    @property
    def num_terms(self) -> int:
        return len(self.terms)

    def weight_matrix(self, step) -> np.ndarray:
        """Evaluate the (num_tags, num_terms) weight matrix host-side."""
        W = np.zeros((len(self.tags), len(self.terms)), np.float32)
        for ti, fns in enumerate(self.weight_fns):
            for j, fn in fns.items():
                W[ti, j] = fn(step)
        return W

    def __call__(self, preds, batch, tag_id, weight_matrix, dataset_weight=None):
        """(loss_sum, {name: (masked values, per-sample weights)}).

        loss_sum is sum(w * v) / B over the full batch; missing labels have
        weight 0. tag_id: (B,) int tensor; weight_matrix: (num_tags, num_terms)
        tensor on the batch's device.
        """
        losses = {}
        B = tag_id.shape[0]
        total = torch.zeros((), dtype=torch.float32, device=tag_id.device)
        tag_id = tag_id.long()
        for j, term in enumerate(self.terms):
            val = term.f(preds, batch)  # (B,)
            w = weight_matrix[tag_id, j]
            if dataset_weight is not None:
                w = w * dataset_weight
            total = total + torch.sum(val * w)
            masked = val * (w != 0)
            if term.name in losses:
                pv, pw = losses[term.name]
                losses[term.name] = (pv + masked, pw + w)
            else:
                losses[term.name] = (masked, w)
        return total / B, losses
