"""The reference's ``dpm`` sampler: DPM-Solver++(2M) in fp32."""

import torch


def sample(eps, sched, x, steps: int):
    """DPM-Solver++(2M) over the linspace grid that reaches t = T-1: first
    order on the first step and into the terminal boundary, second order
    between.  ``eps(x, t)`` is the guided model output."""
    ts = sched.timesteps(steps)
    prev_t = ts[1:] + [-1]
    prev_x0 = prev_lam = None
    for i, t in enumerate(ts):
        x0 = sched.x0(eps(x, t), x, t)
        lam_s, sigma_s = sched.lam[t], sched.sigma[t]
        a_prev = sched.alphas_cumprod[prev_t[i]] if prev_t[i] >= 0 else sched.final
        alpha_p = torch.sqrt(a_prev)
        sigma_p = torch.sqrt(torch.clamp(1.0 - a_prev, min=1e-12))
        lam_p = torch.log(alpha_p) - torch.log(sigma_p)
        h = lam_p - lam_s
        em1 = torch.expm1(-h)
        x_new = (sigma_p / sigma_s) * x - alpha_p * em1 * x0
        if i > 0 and prev_t[i] >= 0:
            r = (lam_s - prev_lam) / h
            x_new = x_new - 0.5 * alpha_p * em1 * (x0 - prev_x0) / r
        prev_x0, prev_lam, x = x0, lam_s, x_new
    return x
