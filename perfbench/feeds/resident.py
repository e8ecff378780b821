"""The `resident` feed: the mix's `n_batches` distinct batches, made on
the device in set-up from the seed and cycled."""
from __future__ import annotations

from perfbench.lib import traffic


class ResidentFeed:
    def __init__(self, batches):
        self.batches = batches
        self.k = 0

    def next(self):
        b = self.batches[self.k % len(self.batches)]
        self.k += 1
        return b

    def counters(self):
        return None

    def check(self, cfg: dict, delivered: list):
        """Nothing to compare on the way: the batches are the reference's."""
        return {}, delivered

    def control(self, cfg: dict) -> dict:
        return {}

    def close(self):
        self.batches = None


def make(cfg: dict, mix: dict, seed: int, device) -> ResidentFeed:
    return ResidentFeed(traffic.make(cfg, mix, seed, device))
