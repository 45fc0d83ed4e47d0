"""Running-average meters (the port's own copy of
``arflow_tpu/utils/meters.py``)."""

from __future__ import annotations


class AverageMeter:
    def __init__(self, i: int = 1, precision: int = 3, names=None):
        self.meters = i
        self.precision = precision
        self.names = names if names is not None else [""] * i
        if len(self.names) != i:
            raise ValueError(f"{len(self.names)} names for {i} meters")
        self.reset()

    def reset(self):
        self.val = [0.0] * self.meters
        self.avg = [0.0] * self.meters
        self.sum = [0.0] * self.meters
        self.count = [0] * self.meters

    def update(self, val, n=1):
        if not isinstance(val, (list, tuple)):
            val = [val]
        if not isinstance(n, (list, tuple)):
            n = [n] * self.meters
        if len(val) != self.meters or len(n) != self.meters:
            raise ValueError(f"{len(val)} values for {self.meters} meters")
        for i, v in enumerate(val):
            self.count[i] += n[i]
            self.val[i] = float(v)
            self.sum[i] += float(v) * n[i]
            self.avg[i] = self.sum[i] / max(self.count[i], 1)

    def __repr__(self):
        val = " ".join(
            f"{n} {v:.{self.precision}f}" for n, v in zip(self.names, self.val)
        )
        avg = " ".join(
            f"{n} {a:.{self.precision}f}" for n, a in zip(self.names, self.avg)
        )
        return f"{val} ({avg})"
