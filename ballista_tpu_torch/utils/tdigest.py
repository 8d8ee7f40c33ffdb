"""T-Digest quantile sketch (merging-digest variant).

Rebuild of the sketch the reference's RuntimeStatsExec keeps per partition
(core/src/execution_plans/runtime_stats.rs:77) to drive the dynamic range
repartitioner's quantile cuts. Mergeable across partitions; serializable
(sketch_to_proto analog via to_list/from_list).
"""

from __future__ import annotations

import math

import numpy as np


class TDigest:
    def __init__(self, compression: int = 200):
        self.compression = compression
        self.means: np.ndarray = np.zeros(0)
        self.weights: np.ndarray = np.zeros(0)
        self._buf_means: list[float] = []
        self._buf_weights: list[float] = []

    def add_array(self, values: np.ndarray) -> None:
        v = values[~np.isnan(values)] if values.dtype.kind == "f" else values
        if len(v) == 0:
            return
        # pre-cluster large inputs cheaply: sort + fixed-size chunks
        v = np.sort(v.astype(np.float64))
        chunk = max(1, len(v) // (self.compression * 4))
        if chunk > 1:
            usable = len(v) - len(v) % chunk
            m = v[:usable].reshape(-1, chunk).mean(axis=1)
            w = np.full(len(m), chunk, dtype=np.float64)
            if usable < len(v):
                m = np.append(m, v[usable:].mean())
                w = np.append(w, len(v) - usable)
        else:
            m, w = v, np.ones(len(v))
        self._buf_means.extend(m.tolist())
        self._buf_weights.extend(w.tolist())
        if len(self._buf_means) > self.compression * 8:
            self._compress()

    def merge(self, other: "TDigest") -> None:
        other._compress()
        self._buf_means.extend(other.means.tolist())
        self._buf_weights.extend(other.weights.tolist())
        self._compress()

    def _compress(self) -> None:
        means = np.concatenate([self.means, np.array(self._buf_means)])
        weights = np.concatenate([self.weights, np.array(self._buf_weights)])
        self._buf_means, self._buf_weights = [], []
        if len(means) == 0:
            return
        order = np.argsort(means)
        means, weights = means[order], weights[order]
        total = weights.sum()
        out_m: list[float] = []
        out_w: list[float] = []
        cum = 0.0
        cur_m, cur_w = means[0], weights[0]
        for m, w in zip(means[1:], weights[1:]):
            q = (cum + cur_w / 2) / total
            limit = 4 * total * q * (1 - q) / self.compression
            if cur_w + w <= max(limit, 1.0):
                cur_m = (cur_m * cur_w + m * w) / (cur_w + w)
                cur_w += w
            else:
                out_m.append(cur_m)
                out_w.append(cur_w)
                cum += cur_w
                cur_m, cur_w = m, w
        out_m.append(cur_m)
        out_w.append(cur_w)
        self.means = np.array(out_m)
        self.weights = np.array(out_w)

    @property
    def count(self) -> float:
        return float(self.weights.sum() + sum(self._buf_weights))

    def quantile(self, q: float) -> float:
        self._compress()
        if len(self.means) == 0:
            return math.nan
        if len(self.means) == 1:
            return float(self.means[0])
        cum = np.cumsum(self.weights) - self.weights / 2
        target = q * self.weights.sum()
        return float(np.interp(target, cum, self.means))

    def quantile_cuts(self, k: int) -> list[float]:
        """k-1 cut points splitting the distribution into k even ranges."""
        return [self.quantile((i + 1) / k) for i in range(k - 1)]

    # -- serde (sketch_to_proto analog) -------------------------------------

    def to_list(self) -> list[list[float]]:
        self._compress()
        return [self.means.tolist(), self.weights.tolist()]

    @classmethod
    def from_list(cls, data: list[list[float]], compression: int = 200) -> "TDigest":
        d = cls(compression)
        d.means = np.array(data[0])
        d.weights = np.array(data[1])
        return d
