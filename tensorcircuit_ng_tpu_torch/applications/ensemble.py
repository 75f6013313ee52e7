"""Model ensembling by bagging/voting (reference ``applications/ai/ensemble.py``).

Framework-agnostic redesign: the reference's ``bagging`` class wraps
tf.keras models; here a model is anything with ``predict(x) -> probs``, a
``torch.nn.Module`` (called without autograd on its own device, numpy input
as float32) or a plain callable; predictions come back as numpy.  Voting strategies: ``weight`` (confidence-weighted),
``average``, and ``most`` (majority vote on hard labels).
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch

Tensor = Any

__all__ = ["bagging", "Bagging"]


class bagging:  # noqa: N801  (reference spells it lowercase)
    """Bag of trained models voting on binary/soft predictions."""

    def __init__(self) -> None:
        self.models: List[Any] = []
        self.model_trained: List[bool] = []
        self.count = 0
        self._permit_train = False

    def append(self, model: Any, model_trained: bool = False) -> None:
        self.models.append(model)
        self.model_trained.append(bool(model_trained))
        self.count += 1

    # --------------------------------------------------------------- train

    def train(
        self,
        train_fn: Optional[Callable[[Any], Any]] = None,
        **kws: Any,
    ) -> None:
        """Train all untrained members.

        ``train_fn(model, **kws)`` when given; otherwise tries the model's
        own ``fit(**kws)`` (keras-style).
        """
        for i, model in enumerate(self.models):
            if self.model_trained[i]:
                continue
            if train_fn is not None:
                self.models[i] = train_fn(model, **kws) or model
            else:
                model.fit(**kws)
            self.model_trained[i] = True

    def compile(self, **kws: Any) -> None:
        """keras-compat: forward compile to members that support it."""
        for model in self.models:
            if hasattr(model, "compile"):
                model.compile(**kws)

    # ------------------------------------------------------------- predict

    def _predict_one(self, i: int, x: Tensor) -> np.ndarray:
        model = self.models[i]
        if hasattr(model, "predict"):
            out = model.predict(x)
        elif isinstance(model, torch.nn.Module):
            p = next(model.parameters(), None)
            dev = p.device if p is not None else torch.device("cpu")
            xt = x.to(dev) if isinstance(x, torch.Tensor) else torch.as_tensor(
                np.asarray(x), dtype=torch.float32, device=dev)
            with torch.no_grad():
                out = model(xt)
        else:
            out = model(x)
        if isinstance(out, torch.Tensor):
            out = out.detach().cpu().numpy()
        out = np.asarray(out)
        if out.ndim == 1:
            out = out[:, None]
        return out

    def predict(self, x: Tensor, voting_policy: str = "weight") -> np.ndarray:
        """Ensemble prediction over samples ``x``.

        ``voting_policy``: ``"weight"`` (confidence-weighted mean of
        probabilities), ``"average"`` (plain mean), ``"most"`` (majority on
        argmax/threshold labels).
        """
        preds = np.stack([self._predict_one(i, x) for i in range(self.count)])
        if voting_policy == "average":
            return preds.mean(axis=0)
        if voting_policy == "weight":
            # confidence = distance from the maximally uncertain prediction
            conf = np.abs(preds - 0.5) + 1e-12
            return (preds * conf).sum(axis=0) / conf.sum(axis=0)
        if voting_policy == "most":
            if preds.shape[-1] == 1:
                labels = (preds[..., 0] > 0.5).astype(int)
                return (labels.mean(axis=0) > 0.5).astype(int)
            labels = preds.argmax(axis=-1)
            nclass = preds.shape[-1]
            counts = np.stack(
                [(labels == k).sum(axis=0) for k in range(nclass)], axis=-1
            )
            return counts.argmax(axis=-1)
        raise ValueError(f"unknown voting_policy {voting_policy!r}")

    def eval(
        self,
        x: Tensor,
        y: Tensor,
        voting_policy: str = "weight",
        metric: str = "acc",
    ) -> float:
        """Accuracy (or mse) of the ensemble prediction against labels."""
        pred = self.predict(x, voting_policy=voting_policy)
        y = np.asarray(y)
        if metric == "mse":
            return float(np.mean((pred - y) ** 2))
        if pred.ndim > 1 and pred.shape[-1] > 1:
            labels = pred.argmax(axis=-1)
        elif pred.ndim > 1:
            labels = (pred[..., 0] > 0.5).astype(int)
        else:
            labels = np.asarray(pred)
        return float(np.mean(labels == y.reshape(labels.shape)))


Bagging = bagging
