"""Per-task streaming evaluation meters.

Counterpart of ``mtlora_tpu/evaluation/meters.py``, with the same
numerical contracts (reference file:line there). Each meter is
``init(device) -> state``, ``update(state, pred, gt, weight) -> state``
and ``compute(state) -> dict``. A state is a dict of fp32 tensors on the
device, the JAX states' dtypes with x64 off. ``update`` takes only sums:
fixed shapes, no boolean indexing, no ``bincount`` (whose output length
is read back from the device) and no host read, so a whole eval loop runs
without a sync. ``compute`` reads the state on the host and works in
float64, as the JAX ``compute`` does.

  - ConfusionIoUMeter (semseg: 21 PASCAL / 40 NYUD classes; human parts:
    7): TP/FP/FN from a confusion matrix summed by ``scatter_add_`` into a
    fixed ``K*K + 1`` buffer whose last slot takes the ignored pixels;
  - NormalsMeter: V1 (acos, the ``rmse == mean`` copy quirk) and V2
    (atan2);
  - SaliencyMeter: 19 beta thresholds (the double-sigmoid quirk) and 15
    no-beta thresholds (no ignore mask; padded rows dropped by the row
    weight), each a broadcast over a thresholds axis;
  - DepthMeter, EdgeMeter (the balanced-CE proxy through
    ``train/losses.py:balanced_bce_logits``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from mtlora_tpu_torch.train.losses import balanced_bce_logits

PASCAL_SEMSEG_CLASSES = 21
NYUD_SEMSEG_CLASSES = 40
HUMAN_PARTS_CLASSES = 7


def get_output(output: torch.Tensor, task: str) -> torch.Tensor:
    """Post-process NHWC logits into meter inputs: normals ->
    ``(unit + 1) * 255 / 2``, seg -> argmax, sal / edge -> ``255 *
    sigmoid``, depth -> squeezed; in the logits' dtype (argmax: int64)."""
    if task == "normals":
        norm = torch.linalg.vector_norm(output, dim=-1, keepdim=True)
        unit = output / torch.clamp(norm, min=1e-12)
        return (unit + 1.0) * 255.0 / 2.0
    if task in ("semseg", "human_parts"):
        return torch.argmax(output, dim=-1)
    if task in ("edge", "sal"):
        return (255.0 * torch.sigmoid(output)).squeeze(-1)
    if task == "depth":
        return output.squeeze(-1)
    raise ValueError(f"unknown task {task}")


def _zeros(shape, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=device)


class MeterBase:
    def init(self, device="cpu") -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def update(self, state: Dict, pred, gt, weight=None) -> Dict:
        """``weight``: optional per-sample [B] 0/1 validity; rows with
        weight 0 (padding of the ragged last batch) contribute exactly
        nothing, meters being sum accumulators."""
        raise NotImplementedError

    def compute(self, state: Dict, verbose: bool = False) -> Dict:
        raise NotImplementedError


def _squeeze_label(gt: torch.Tensor) -> torch.Tensor:
    if gt.dim() == 4 and gt.shape[-1] == 1:
        gt = gt[..., 0]
    return gt


def _row_ignore(gt: torch.Tensor, weight, fill) -> torch.Tensor:
    """Overwrite whole samples (rows) with ``weight == 0`` by the meter's
    ignore value, so every mask-based accumulator skips them."""
    if weight is None:
        return gt
    w = weight.reshape((gt.shape[0],) + (1,) * (gt.dim() - 1))
    return torch.where(w > 0, gt, torch.full((), fill, dtype=gt.dtype,
                                             device=gt.device))


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().double().numpy()


class ConfusionIoUMeter(MeterBase):
    """Shared TP/FP/FN IoU machinery for semseg / human parts."""

    def __init__(self, n_classes: int, ignore_index: int = 255):
        self.n_classes = n_classes
        self.ignore_index = ignore_index

    def init(self, device="cpu"):
        z = _zeros((self.n_classes,), device)
        return {"tp": z, "fp": z.clone(), "fn": z.clone()}

    def update(self, state, pred, gt, weight=None):
        K = self.n_classes
        gt = _squeeze_label(gt).to(torch.int64)
        gt = _row_ignore(gt, weight, self.ignore_index)
        pred = pred.to(torch.int64)
        valid = gt != self.ignore_index
        idx = torch.where(valid, gt * K + pred,
                          torch.full((), K * K, dtype=torch.int64,
                                     device=gt.device)).reshape(-1)
        # integer counts (exact), then fp32 as the JAX state
        cm = torch.zeros(K * K + 1, dtype=torch.int64, device=gt.device)
        cm.scatter_add_(0, idx, torch.ones_like(idx))
        cm = cm[: K * K].view(K, K).to(state["tp"].dtype)
        tp = torch.diagonal(cm)
        fp = cm.sum(0) - tp
        fn = cm.sum(1) - tp
        return {"tp": state["tp"] + tp, "fp": state["fp"] + fp,
                "fn": state["fn"] + fn}

    def compute(self, state, verbose=False):
        tp, fp, fn = (_host(state[k]) for k in ("tp", "fp", "fn"))
        jac = tp / np.maximum(tp + fp + fn, 1e-8)
        return {"jaccards_all_categs": jac.tolist(),
                "mIoU": float(jac.mean())}


class SemsegMeter(ConfusionIoUMeter):
    def __init__(self, database: str = "PASCALContext"):
        if database == "PASCALContext":
            super().__init__(PASCAL_SEMSEG_CLASSES)
        elif database == "NYUD":
            super().__init__(NYUD_SEMSEG_CLASSES)
        else:
            raise NotImplementedError(database)


class HumanPartsMeter(ConfusionIoUMeter):
    def __init__(self, database: str = "PASCALContext"):
        assert database == "PASCALContext"
        super().__init__(HUMAN_PARTS_CLASSES)


def _unit(v: torch.Tensor) -> torch.Tensor:
    n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return torch.where(n == 0, 0.0, v / torch.where(n == 0, 1.0, n))


class NormalsMeter(MeterBase):
    """Combines the reference's V1 (acos) and V2 (atan2) formulas."""

    KEYS = ("v1_sum", "v1_1125", "v1_225", "v1_30", "v1_n", "v2_sum", "v2_n")

    def init(self, device="cpu"):
        return {k: _zeros((), device) for k in self.KEYS}

    def update(self, state, pred, gt, weight=None):
        # pred: [B,H,W,3] in 0..255 (get_output); gt: [B,H,W,3] floats
        p = 2.0 * pred.float() / 255.0 - 1.0
        g = _row_ignore(gt.float(), weight, 255.0)
        # V1: mask where ANY element is 255; the valid mask is channel 0's
        invalid = g == 255.0
        p1 = torch.where(invalid, 0.0, p)
        g1 = torch.where(invalid, 0.0, g)
        dot = torch.clamp((p1 * g1).sum(-1), -1.0, 1.0)
        deg = torch.rad2deg(torch.arccos(dot))
        valid1 = ~invalid[..., 0]
        deg = torch.where(valid1, deg, 0.0)
        upd = {"v1_sum": state["v1_sum"] + deg.sum(),
               "v1_n": state["v1_n"] + valid1.sum().float()}
        for key, thr in (("v1_1125", 11.25), ("v1_225", 22.5),
                         ("v1_30", 30.0)):
            passed = (valid1 & (deg < thr)).sum().float()
            upd[key] = state[key] + 100.0 * passed
        # V2: normalize both, angle via atan2; valid where ALL channels
        # != 255
        p2, g2 = _unit(p), _unit(g)
        ang = torch.rad2deg(2.0 * torch.atan2(
            torch.linalg.vector_norm(p2 - g2, dim=-1),
            torch.linalg.vector_norm(p2 + g2, dim=-1)))
        valid2 = (g != 255.0).all(-1)
        upd["v2_sum"] = state["v2_sum"] + torch.where(valid2, ang, 0.0).sum()
        upd["v2_n"] = state["v2_n"] + valid2.sum().float()
        return upd

    def compute(self, state, verbose=False):
        s = {k: float(_host(v)) for k, v in state.items()}
        n1 = max(s["v1_n"], 1.0)
        n2 = max(s["v2_n"], 1.0)
        mean_v1 = s["v1_sum"] / n1
        mean_v2 = s["v2_sum"] / n2
        return {
            "mean": mean_v1,
            "rmse": mean_v1,       # reference copy quirk preserved
            "mean_v2": mean_v2,
            "rmse_v2": mean_v2,
            "11.25": s["v1_1125"] / n1,
            "22.5": s["v1_225"] / n1,
            "30": s["v1_30"] / n1,
        }


class SaliencyMeter(MeterBase):
    """Beta (19-threshold F-beta) + no-beta (15-threshold per-image
    jaccard / F) saliency meters fused into one state."""

    def __init__(self, ignore_index: int = 255, threshold_step: float = 0.05,
                 beta_squared: float = 0.3):
        self.ignore_index = ignore_index
        self.beta_squared = beta_squared
        self.beta_thresholds = np.arange(threshold_step, 1.0,
                                         threshold_step)  # 19
        self.nb_thresholds = np.linspace(0.2, 0.9, 15)
        self._thr = {}   # device -> fp32 (beta, no-beta) thresholds

    def _thresholds(self, device):
        """The thresholds as fp32 tensors on ``device``, copied there once
        (by :meth:`init`, outside the eval loop: a copy from host memory
        waits for the stream)."""
        key = torch.device(device)
        if key not in self._thr:
            self._thr[key] = tuple(
                torch.as_tensor(t, dtype=torch.float32, device=key)
                for t in (self.beta_thresholds, self.nb_thresholds))
        return self._thr[key]

    def init(self, device="cpu"):
        nb, nn_ = len(self.beta_thresholds), len(self.nb_thresholds)
        self._thresholds(device)
        return {"tp": _zeros((nb,), device), "pred_pos": _zeros((nb,), device),
                "act_pos": _zeros((nb,), device),
                "jac_sum": _zeros((nn_,), device),
                "prec_sum": _zeros((nn_,), device),
                "rec_sum": _zeros((nn_,), device),
                "n_img": _zeros((), device)}

    def update(self, state, pred, gt, weight=None):
        # pred: [B,H,W] 0..255 (get_output); gt: [B,H,W(,1)] binary
        dev = pred.device
        B = pred.shape[0]
        beta_thr, nb_thr = self._thresholds(dev)
        gt = _squeeze_label(gt).float()
        p01 = pred.float() / 255.0
        gtb = _row_ignore(gt, weight, 255.0)
        valid = (gtb != self.ignore_index).reshape(1, -1)
        # beta meter: the double-sigmoid quirk (eval_sal_beta.py:38,55);
        # thresholds on a leading axis [19, B*H*W]
        pbeta = torch.sigmoid(p01).reshape(1, -1)
        gl = gtb.to(torch.int32).reshape(1, -1)
        thr = beta_thr[:, None]
        f = valid & (pbeta >= thr)
        tps = (f & (gl > 0)).sum(1).float()
        pps = f.sum(1).float()
        aps = torch.where(valid, gl, 0).sum().float().expand(len(thr))
        # no-beta meter: per-image jaccard / prec / rec. This meter has NO
        # ignore mask (reference quirk), so 0-weight padded rows are
        # excluded by weighting the per-image sums, not the gt
        gb = (gt > 0.5).reshape(1, B, -1)        # gt already binarized
        wrow = (torch.ones(B, dtype=torch.float32, device=dev)
                if weight is None else weight.float())
        mask = p01.reshape(1, B, -1) > nb_thr[:, None, None]  # [15, B, HW]
        inter = (gb & mask).sum(-1).float()
        union = (gb | mask).sum(-1).float()
        gsum = gb.sum(-1).float()
        msum = mask.sum(-1).float()
        both_empty = (torch.isclose(gsum, torch.zeros_like(gsum))
                      & torch.isclose(msum, torch.zeros_like(msum)))
        jac = torch.where(both_empty, 1.0,
                          inter / torch.clamp(union, min=1e-12))
        prec = inter / (msum + 1e-12)
        rec = inter / (gsum + 1e-12)
        return {"tp": state["tp"] + tps,
                "pred_pos": state["pred_pos"] + pps,
                "act_pos": state["act_pos"] + aps,
                "jac_sum": state["jac_sum"] + (jac * wrow).sum(1),
                "prec_sum": state["prec_sum"] + (prec * wrow).sum(1),
                "rec_sum": state["rec_sum"] + (rec * wrow).sum(1),
                "n_img": state["n_img"] + wrow.sum()}

    def compute(self, state, verbose=False):
        tp = _host(state["tp"])
        with np.errstate(divide="ignore", invalid="ignore"):
            prec = tp / _host(state["pred_pos"])
            rec = tp / _host(state["act_pos"])
            num = (1 + self.beta_squared) * prec * rec
            den = self.beta_squared * prec + rec
            f = num / den
        f = np.nan_to_num(f, nan=0.0)
        n = max(float(_host(state["n_img"])), 1.0)
        mprec = _host(state["prec_sum"]) / n
        mrec = _host(state["rec_sum"]) / n
        fs = 2 * mprec * mrec / (mprec + mrec + 1e-12)
        mious = _host(state["jac_sum"]) / n
        return {"Beta maxF": float(f.max()),
                "maxF": float(fs.max()),
                "mIoU": float(mious.max())}


class DepthMeter(MeterBase):
    def init(self, device="cpu"):
        return {k: _zeros((), device) for k in ("sq", "log_sq", "n")}

    def update(self, state, pred, gt, weight=None):
        gt = _row_ignore(_squeeze_label(gt).float(), weight, 255.0)
        pred = torch.clamp(pred.float(), min=1e-9)
        mask = gt != 255.0
        safe_gt = torch.where(mask, gt, 1.0)
        sq = torch.where(mask, (gt - pred) ** 2, 0.0).sum()
        lsq = torch.where(mask, (torch.log(safe_gt) - torch.log(pred)) ** 2,
                          0.0).sum()
        return {"sq": state["sq"] + sq, "log_sq": state["log_sq"] + lsq,
                "n": state["n"] + mask.sum().float()}

    def compute(self, state, verbose=False):
        s = {k: float(_host(v)) for k, v in state.items()}
        n = max(s["n"], 1.0)
        return {"rmse": float(np.sqrt(s["sq"] / n)),
                "log_rmse": float(np.sqrt(s["log_sq"] / n))}


class EdgeMeter(MeterBase):
    def __init__(self, pos_weight: float = 0.95):
        self.pos_weight = pos_weight

    def init(self, device="cpu"):
        return {"loss": _zeros((), device), "n": _zeros((), device)}

    def update(self, state, pred, gt, weight=None):
        gt = _squeeze_label(gt).float()
        p = pred.float() / 255.0     # probabilities-as-logits quirk
        loss = balanced_bce_logits(p, gt, pos_weight=self.pos_weight,
                                   row_weight=weight)
        if weight is None:
            numel = float(gt.numel())
        else:
            numel = weight.float().sum() * (gt.numel() // gt.shape[0])
        return {"loss": state["loss"] + numel * loss,
                "n": state["n"] + numel}

    def compute(self, state, verbose=False):
        return {"loss": float(_host(state["loss"]))
                / max(float(_host(state["n"])), 1.0)}


def get_single_task_meter(task: str, database: str = "PASCALContext",
                          edge_pos_weight: float = 0.95) -> MeterBase:
    """Meter dispatch (evaluate_utils.py:96-126)."""
    if task == "semseg":
        return SemsegMeter(database)
    if task == "human_parts":
        return HumanPartsMeter(database)
    if task == "normals":
        return NormalsMeter()
    if task == "sal":
        return SaliencyMeter()
    if task == "depth":
        return DepthMeter()
    if task == "edge":
        return EdgeMeter(pos_weight=edge_pos_weight)
    raise NotImplementedError(task)


class PerformanceMeter:
    """Multi-task wrapper (evaluate_utils.py:41-63) whose states live on
    ``device``."""

    def __init__(self, tasks, database: str = "PASCALContext",
                 device="cpu"):
        self.tasks = list(tasks)
        self.device = torch.device(device)
        self.meters = {t: get_single_task_meter(t, database)
                       for t in self.tasks}
        self.reset()

    def reset(self):
        self.states = {t: self.meters[t].init(self.device)
                       for t in self.tasks}

    def update(self, preds: Dict, targets: Dict, processed: bool = False,
               weight=None):
        """preds: raw NHWC logits (or get_output results if processed)."""
        for t in self.tasks:
            p = preds[t] if processed else get_output(preds[t], t)
            self.states[t] = self.meters[t].update(self.states[t], p,
                                                   targets[t], weight)

    def update_states(self, states, preds, targets, weight=None):
        """Pure functional update (the JAX ``update_jit``): new states
        from ``states`` and raw logits; ``weight`` an optional per-sample
        [B] 0/1 validity (padded rows contribute exactly nothing)."""
        return {t: self.meters[t].update(states[t], get_output(preds[t], t),
                                         targets[t], weight)
                for t in self.tasks}

    def get_score(self, verbose: bool = True) -> Dict:
        scores = {t: self.meters[t].compute(self.states[t])
                  for t in self.tasks}
        if verbose:
            for t, s in scores.items():
                msg = ", ".join(f"{k}: {v:.4f}" for k, v in s.items()
                                if isinstance(v, float))
                print(f"[{t}] {msg}")
        return scores


def calculate_multi_task_performance(eval_dict: Dict,
                                     single_task_dict: Dict) -> float:
    """MTL delta vs single-task baselines (evaluate_utils.py:66-93)."""
    assert set(eval_dict) == set(single_task_dict)
    total = 0.0
    for task in eval_dict:
        mtl, stl = eval_dict[task], single_task_dict[task]
        if task == "depth":
            total -= (mtl["rmse"] - stl["rmse"]) / stl["rmse"]
        elif task in ("semseg", "sal", "human_parts"):
            total += (mtl["mIoU"] - stl["mIoU"]) / stl["mIoU"]
        elif task == "normals":
            total -= (mtl["mean"] - stl["mean"]) / stl["mean"]
        elif task == "edge":
            total += (mtl["odsF"] - stl["odsF"]) / stl["odsF"]
        else:
            raise NotImplementedError(task)
    return total / len(eval_dict)
