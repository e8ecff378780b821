"""The fed mix's source stage, in a module of its own so that a spawned
pipeline worker imports numpy alone."""
from __future__ import annotations

import numpy as np


class FileBlocks:
    """Each call reads the next raw block's `.npz` file, in a cycle over
    `paths`. Picklable; reads nothing until called."""

    def __init__(self, paths):
        self.paths = list(paths)
        self._k = 0

    def __call__(self):
        path = self.paths[self._k % len(self.paths)]
        self._k += 1
        with np.load(path) as z:
            return {n: z[n] for n in z.files}
