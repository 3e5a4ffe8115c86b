"""The reference's ``euler`` sampler: diffusers' EulerDiscreteScheduler in
fp32 (deterministic: no churn), on the schedule's ``timestep_spacing``:
"leading" (t = i * (T // n) + steps_offset, descending; the initial noise
sqrt(sigma_max^2 + 1), as SDXL publishes it) or "linspace" (t on
linspace(0, T - 1, n), the initial noise sigma_max)."""

import numpy as np
import torch


def grid(sched, steps: int):
    """(timesteps, sigmas with a final 0, initial noise scale)."""
    n_train = sched.n
    spacing = getattr(sched, "timestep_spacing", "linspace")
    if spacing == "leading":
        ratio = n_train // steps
        ts = (np.arange(steps) * ratio).round()[::-1].astype(np.float64)
        ts = ts + getattr(sched, "steps_offset", 0)
    elif spacing == "linspace":
        ts = np.linspace(0, n_train - 1, steps)[::-1].copy()
    else:
        raise ValueError(f"the reference's euler has no spacing {spacing!r}")
    ac = sched.alphas_cumprod.double().numpy()
    table = np.sqrt((1.0 - ac) / ac)
    sig = np.interp(ts, np.arange(n_train), table)
    sigmas = np.append(sig, 0.0).astype(np.float32)
    smax = float(sigmas[0])
    init = smax if spacing == "linspace" else float(np.sqrt(smax * smax + 1.0))
    return ts.tolist(), torch.tensor(sigmas), init


def sample(eps, sched, x, steps: int):
    """Euler over the grid: the model reads ``x / sqrt(sigma^2 + 1)`` at the
    float timestep, then ``x += d * (sigma_next - sigma)`` with ``d = (x -
    x0) / sigma``.  ``eps(x, t)`` is the guided model output."""
    ts, sigmas, init = grid(sched, steps)
    x = x * init
    for i, t in enumerate(ts):
        sigma, sigma_next = sigmas[i], sigmas[i + 1]
        out = eps(x / torch.sqrt(sigma ** 2 + 1.0), float(t))
        if sched.prediction == "epsilon":
            x0 = x - sigma * out
        else:
            x0 = (-sigma / torch.sqrt(sigma ** 2 + 1.0)) * out + x / (sigma ** 2 + 1.0)
        x = x + (x - x0) / sigma * (sigma_next - sigma)
    return x
