"""The ``scaled_linear`` beta schedule: betas whose square roots are evenly
spaced."""

import numpy as np


def betas(lo: float, hi: float, n: int) -> np.ndarray:
    return np.linspace(lo ** 0.5, hi ** 0.5, n, dtype=np.float64) ** 2
