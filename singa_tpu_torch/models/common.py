"""The shared training step of the classifiers (counterpart of
singa_tpu/models/common.py)."""

from __future__ import annotations

from singa_tpu_torch import autograd, model

__all__ = ["Classifier"]


class Classifier(model.Model):
    """Model with the standard step: mean softmax cross-entropy of the
    logits against int labels, then the optimizer."""

    def train_one_batch(self, x, y, dist_option: str = "plain", spars=None):
        out = self.forward(x)
        loss = autograd.softmax_cross_entropy(out, y)
        self._apply_opt(loss, dist_option, spars)
        return out, loss
