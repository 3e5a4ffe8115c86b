"""Noise schedulers (port of the JAX ``models/schedulers.py``): the config,
DDPM (the training forward process and its ancestral step) and DDIM, the
pipeline's default sampler.  The other samplers come later.

Tables are fp32 tensors as in the JAX package, and the step's coefficients
are computed in fp32, so a step here matches a step there.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    prediction_type: str = "epsilon"  # or "v_prediction"
    clip_sample: bool = False
    set_alpha_to_one: bool = False  # DDIM final-alpha convention (SD uses False)
    steps_offset: int = 1  # SD pipelines use steps_offset=1

    def betas(self) -> np.ndarray:
        n = self.num_train_timesteps
        if self.beta_schedule == "scaled_linear":
            return np.linspace(self.beta_start ** 0.5, self.beta_end ** 0.5, n,
                               dtype=np.float64) ** 2
        if self.beta_schedule == "linear":
            return np.linspace(self.beta_start, self.beta_end, n, dtype=np.float64)
        if self.beta_schedule == "squaredcos_cap_v2":
            t = np.arange(n, dtype=np.float64)
            f = lambda u: np.cos((u / n + 0.008) / 1.008 * np.pi / 2) ** 2
            return np.clip(1.0 - f(t + 1) / f(t), 0, 0.999)
        raise ValueError(f"unknown beta schedule {self.beta_schedule}")


class DDPMScheduler:
    """Forward process and ancestral sampling step (JAX :59-133)."""

    def __init__(self, config: SchedulerConfig = SchedulerConfig()):
        self.config = config
        betas = config.betas()
        alphas = 1.0 - betas
        self.alphas_cumprod = torch.tensor(np.cumprod(alphas), dtype=torch.float32)
        self.betas = torch.tensor(betas, dtype=torch.float32)
        self.alphas = torch.tensor(alphas, dtype=torch.float32)
        self.num_train_timesteps = config.num_train_timesteps

    def _coeffs(self, sample: torch.Tensor, timesteps: torch.Tensor):
        """sqrt(a_t) and sqrt(1 - a_t) per example, shaped to broadcast over
        ``sample`` and cast to its dtype (computed in fp32)."""
        a = self.alphas_cumprod.to(sample.device)[timesteps.to(sample.device).long()]
        shape = (-1,) + (1,) * (sample.ndim - 1)
        return (torch.sqrt(a).reshape(shape).to(sample.dtype),
                torch.sqrt(1.0 - a).reshape(shape).to(sample.dtype))

    def add_noise(self, sample: torch.Tensor, noise: torch.Tensor,
                  timesteps: torch.Tensor) -> torch.Tensor:
        """x_t = sqrt(a_t) x_0 + sqrt(1 - a_t) eps (per-example timesteps)."""
        sqrt_a, sqrt_1ma = self._coeffs(sample, timesteps)
        return sqrt_a * sample + sqrt_1ma * noise

    def get_velocity(self, sample: torch.Tensor, noise: torch.Tensor,
                     timesteps: torch.Tensor) -> torch.Tensor:
        """v-prediction target: v = sqrt(a) eps - sqrt(1 - a) x_0."""
        sqrt_a, sqrt_1ma = self._coeffs(sample, timesteps)
        return sqrt_a * noise - sqrt_1ma * sample

    def training_target(self, sample: torch.Tensor, noise: torch.Tensor,
                        timesteps: torch.Tensor) -> torch.Tensor:
        """epsilon or v target per config."""
        if self.config.prediction_type == "epsilon":
            return noise
        if self.config.prediction_type == "v_prediction":
            return self.get_velocity(sample, noise, timesteps)
        raise ValueError(f"Unknown prediction type {self.config.prediction_type}")

    def step(self, model_output: torch.Tensor, timestep: int, sample: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One ancestral step from ``timestep``; the noise is ``noise`` if
        given, else drawn from ``generator`` in the sample's dtype."""
        t = int(timestep)
        a_t = self.alphas_cumprod[t]
        a_prev = self.alphas_cumprod[t - 1] if t > 0 else torch.tensor(1.0)
        beta_t, alpha_t = self.betas[t], self.alphas[t]
        if self.config.prediction_type == "epsilon":
            x0 = (sample - torch.sqrt(1.0 - a_t) * model_output) / torch.sqrt(a_t)
        elif self.config.prediction_type == "v_prediction":
            x0 = torch.sqrt(a_t) * sample - torch.sqrt(1.0 - a_t) * model_output
        else:
            raise ValueError(self.config.prediction_type)
        if self.config.clip_sample:
            x0 = x0.clamp(-1.0, 1.0)
        pred_orig_coeff = torch.sqrt(a_prev) * beta_t / (1.0 - a_t)
        current_coeff = torch.sqrt(alpha_t) * (1.0 - a_prev) / (1.0 - a_t)
        mean = pred_orig_coeff * x0 + current_coeff * sample
        if t == 0:
            return mean
        var = torch.clamp(beta_t * (1.0 - a_prev) / (1.0 - a_t), min=1e-20)
        if noise is None:
            noise = torch.randn(sample.shape, generator=generator, device=sample.device,
                                dtype=sample.dtype)
        return mean + torch.sqrt(var) * noise


class DDIMScheduler:
    """Deterministic (eta = 0) DDIM sampling over a strided timestep grid, as
    the pipeline runs it; stochastic DDIM (eta > 0) comes with a caller."""

    def __init__(self, config: SchedulerConfig = SchedulerConfig()):
        self.config = config
        self.alphas_cumprod = torch.tensor(np.cumprod(1.0 - config.betas()),
                                           dtype=torch.float32)
        self.final_alpha_cumprod = (torch.tensor(1.0) if config.set_alpha_to_one
                                    else self.alphas_cumprod[0])
        self.num_train_timesteps = config.num_train_timesteps

    def timesteps(self, num_inference_steps: int) -> torch.Tensor:
        """Descending grid with SD's steps_offset convention (int64)."""
        step = self.num_train_timesteps // num_inference_steps
        ts = (np.arange(0, num_inference_steps) * step).round()[::-1].astype(np.int64)
        ts = np.clip(ts + self.config.steps_offset, 0, self.num_train_timesteps - 1)
        return torch.from_numpy(ts.copy())

    def step(self, model_output: torch.Tensor, timestep: int, sample: torch.Tensor,
             num_inference_steps: int) -> torch.Tensor:
        """One deterministic (eta = 0) DDIM step from ``timestep``."""
        t = int(timestep)
        prev_t = t - self.num_train_timesteps // num_inference_steps
        a_t = self.alphas_cumprod[t]
        a_prev = self.alphas_cumprod[prev_t] if prev_t >= 0 else self.final_alpha_cumprod
        # 0-d fp32 CPU tensors: usable with a sample on any device
        sqrt_a, sqrt_1ma = torch.sqrt(a_t), torch.sqrt(1.0 - a_t)

        if self.config.prediction_type == "epsilon":
            x0 = (sample - sqrt_1ma * model_output) / sqrt_a
            eps = model_output
        elif self.config.prediction_type == "v_prediction":
            x0 = sqrt_a * sample - sqrt_1ma * model_output
            eps = sqrt_a * model_output + sqrt_1ma * sample
        else:
            raise ValueError(self.config.prediction_type)
        if self.config.clip_sample:
            x0 = x0.clamp(-1.0, 1.0)
        prev = torch.sqrt(a_prev) * x0 + torch.sqrt(1.0 - a_prev) * eps
        return prev.to(sample.dtype)
