"""Host-side learning-rate schedulers (the port's own copy of
``tss_dprnn_tpu/training/schedulers.py``): exponential decay when
``decay_rate`` is set, ReduceLROnPlateau on the eval loss otherwise."""

from __future__ import annotations


class ExponentialDecay:
    """torch ExponentialLR: lr *= gamma every epoch."""

    def __init__(self, lr: float, gamma: float):
        self.lr = lr
        self.gamma = gamma

    def step(self, metric=None) -> float:
        self.lr *= self.gamma
        return self.lr

    def state_dict(self) -> dict:
        return {"lr": self.lr}

    def load_state_dict(self, sd: dict) -> None:
        self.lr = float(sd["lr"])


class ReduceLROnPlateau:
    """torch ReduceLROnPlateau in min mode with its default relative
    threshold 1e-4 and no lower bound: after more than ``patience`` epochs
    without improvement the lr is multiplied by ``factor``."""

    THRESHOLD = 1e-4

    def __init__(self, lr: float, factor: float = 0.5, patience: int = 2):
        self.lr = lr
        self.factor = factor
        self.patience = patience
        self.best = float("inf")
        self.num_bad = 0

    def step(self, metric: float) -> float:
        if metric < self.best * (1 - self.THRESHOLD):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr *= self.factor
                self.num_bad = 0
        return self.lr

    def state_dict(self) -> dict:
        return {"lr": self.lr, "best": self.best, "num_bad": self.num_bad}

    def load_state_dict(self, sd: dict) -> None:
        self.lr = float(sd["lr"])
        self.best = float(sd["best"])
        self.num_bad = int(sd["num_bad"])
