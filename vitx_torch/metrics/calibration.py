"""Confidence calibration: ECE and temperature scaling (Guo et al. 2017).

The counterpart of ``vitx/metrics/calibration.py``: expected calibration
error over equal-width confidence bins, and the temperature that minimises
the NLL of ``logits / T``, fitted by 30 clipped Newton steps on ``log T``
from 0, as vitx fits it (its derivatives by ``jax.grad``, these by
autograd). Everything in fp32.
"""

from __future__ import annotations

import torch


def expected_calibration_error(probs, labels, num_bins: int = 15):
    """ECE of (N, C) probabilities against (N,) labels: sum over bins of
    (n_b / N) |acc_b - conf_b|."""
    probs = torch.as_tensor(probs).float()
    labels = torch.as_tensor(labels).to(probs.device)
    conf, pred = probs.max(dim=-1)
    correct = (pred == labels).float()
    idx = torch.clamp((conf * num_bins).to(torch.int32), 0, num_bins - 1)
    onehot = torch.nn.functional.one_hot(idx.long(), num_bins).float()
    n_b = onehot.sum(dim=0)
    gap = torch.abs(correct @ onehot - conf @ onehot) / torch.clamp_min(
        n_b, 1.0)
    return (gap * n_b).sum() / probs.shape[0]


def _nll(logits, labels, t):
    logp = torch.log_softmax(logits / torch.exp(t), dim=-1)
    return -logp.gather(-1, labels[:, None]).mean()


def fit_temperature(logits, labels):
    """argmin_T NLL(logits / T) by Newton's method on t = log T: 30 steps,
    each clipped to [-1, 1], the curvature's magnitude floored at 1e-8."""
    logits = torch.as_tensor(logits).float()
    labels = torch.as_tensor(labels).long().to(logits.device)
    t = torch.zeros((), device=logits.device)
    for _ in range(30):
        tt = t.detach().requires_grad_()
        (g,) = torch.autograd.grad(_nll(logits, labels, tt), tt,
                                   create_graph=True)
        (h,) = torch.autograd.grad(g, tt)
        step = g.detach() / torch.clamp_min(h.abs(), 1e-8)
        t = t - torch.clamp(step, -1.0, 1.0)
    return torch.exp(t)


def calibration_report(logits, labels, num_bins: int = 15) -> dict:
    """Fit T and report ECE and NLL before and after scaling, rounded to 4
    places (host floats)."""
    logits = torch.as_tensor(logits).float()
    labels = torch.as_tensor(labels).long().to(logits.device)
    temp = fit_temperature(logits, labels)

    def stats(lg):
        probs = torch.softmax(lg, dim=-1)
        nll = -torch.log_softmax(lg, dim=-1).gather(
            -1, labels[:, None]).mean()
        return expected_calibration_error(probs, labels, num_bins), nll

    ece0, nll0 = stats(logits)
    ece1, nll1 = stats(logits / temp)
    return {
        "temperature": round(float(temp), 4),
        "ece_before": round(float(ece0), 4),
        "ece_after": round(float(ece1), 4),
        "nll_before": round(float(nll0), 4),
        "nll_after": round(float(nll1), 4),
    }
