"""The DeiT distillation loss (port of
``chambers_tpu/losses/distillation.py``) over a
``DistilledVisionTransformer``'s ``[x_cls, x_dist]`` output.

Hard distillation (the paper's best variant)::

    L = 1/2 CE(cls_logits, y) + 1/2 CE(dist_logits, argmax teacher_logits)

Soft distillation::

    L = (1 - alpha) CE(cls_logits, y)
        + alpha tau^2 KL(softmax(teacher/tau) || softmax(dist/tau))

Everything is computed in float32. The teacher's logits are an input: any
frozen model gives them.
"""

import torch

from chambers_tpu_torch.losses.base import Loss


def softmax_cross_entropy_with_integer_labels(logits, labels):
    """``logsumexp(logits) - logits[label]`` per row, as optax computes
    it."""
    label_logits = torch.gather(logits, -1, labels[..., None].to(
        torch.int64))[..., 0]
    return torch.logsumexp(logits, dim=-1) - label_logits


class DistillationLoss(Loss):
    """DeiT dual-head distillation loss.

    :param kind: ``"hard"`` (cross-entropy against the teacher's argmax)
        or ``"soft"`` (temperature-scaled KL).
    :param alpha: soft distillation's weight on the KL term (hard fixes
        the mix at 1/2).
    :param tau: soft distillation's temperature.

    Call as ``loss((labels, teacher_logits), [cls_logits, dist_logits])``:
    labels int ``[b]``, teacher logits ``[b, classes]``.
    """

    def __init__(self, kind="hard", alpha=0.5, tau=3.0, name="distillation",
                 reduction="sum_over_batch_size"):
        super().__init__(reduction=reduction, name=name)
        if kind not in ("hard", "soft"):
            raise ValueError(f"kind must be 'hard'|'soft', got {kind!r}")
        if not 0.0 <= alpha <= 1.0:
            raise ValueError(f"alpha={alpha} must be in [0, 1]")
        if tau <= 0:
            raise ValueError(f"tau={tau} must be > 0")
        self.kind = kind
        self.alpha = float(alpha)
        self.tau = float(tau)

    def call(self, y_true, y_pred):
        """Per-sample losses ``[b]``."""
        labels, teacher_logits = y_true
        cls_logits, dist_logits = (p.to(torch.float32) for p in y_pred)
        dev = cls_logits.device
        labels = torch.as_tensor(labels, device=dev)
        teacher_logits = torch.as_tensor(teacher_logits, device=dev).to(
            torch.float32)
        ce_cls = softmax_cross_entropy_with_integer_labels(cls_logits, labels)
        if self.kind == "hard":
            teacher_labels = torch.argmax(teacher_logits, dim=-1)
            ce_dist = softmax_cross_entropy_with_integer_labels(
                dist_logits, teacher_labels)
            return 0.5 * ce_cls + 0.5 * ce_dist
        tau = self.tau
        teacher_probs = torch.softmax(teacher_logits / tau, dim=-1)
        student_logp = torch.log_softmax(dist_logits / tau, dim=-1)
        kl = (teacher_probs * (torch.log(teacher_probs.clamp(min=1e-12))
                               - student_logp)).sum(dim=-1)
        return (1.0 - self.alpha) * ce_cls + self.alpha * tau ** 2 * kl

    def get_config(self):
        return {"kind": self.kind, "alpha": self.alpha, "tau": self.tau,
                "reduction": self.reduction}

    @classmethod
    def from_config(cls, config):
        return cls(**config)
