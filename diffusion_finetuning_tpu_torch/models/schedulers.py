"""Noise schedulers (port of the JAX ``models/schedulers.py``): the config,
DDPM (the training forward process and its ancestral step), DDIM (the
pipeline's default sampler; stochastic with ``eta > 0``), and the samplers
PNDM, DPM-Solver++ (2M), Euler, Euler-ancestral and LMS, the sigma-space
three optionally on the Karras rho-7 grid.  :func:`txt2img_scheduler` and
:func:`img2img_scheduler` pick one by name; :func:`restart_on_tail` restarts
img2img's on the grid's tail.

Tables are fp32 as in the JAX package, and a step's coefficients are
computed in fp32 (0-d CPU tensors, usable with samples on any device), so a
step here matches a step there.  The JAX samplers carry their step counter
and history in a state for ``lax.scan``; here the pipeline's loop is Python
(captured whole into one CUDA graph on the card), so the counter is an int
and the history a list, and each branch the JAX step takes with
``jnp.where`` on the counter is a Python branch.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, Optional

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


@dataclasses.dataclass(frozen=True)
class SpacedSchedulerConfig(SchedulerConfig):
    """:class:`SchedulerConfig` with diffusers' ``timestep_spacing``, which
    the Euler samplers follow: "leading" (``EulerDiscreteScheduler`` as SDXL
    publishes it: t = i * (T // n) + steps_offset, and the initial noise
    sqrt(sigma_max^2 + 1)) or "linspace" (the JAX package's grid, which a
    plain :class:`SchedulerConfig` means).  The JAX package's config has no
    such key; the SDXL pipe uses this one."""

    timestep_spacing: str = "leading"


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
        self._alphas_cumprod_on: Dict[torch.device, torch.Tensor] = {}

    def _coeffs(self, sample: torch.Tensor, timesteps: torch.Tensor):
        """sqrt(a_t) and sqrt(1 - a_t) per example, shaped to broadcast over
        ``sample`` and cast to its dtype (computed in fp32).  The table is
        copied to the sample's device once: a CUDA graph cannot capture a
        copy from pageable host memory."""
        table = self._alphas_cumprod_on.get(sample.device)
        if table is None:
            table = self._alphas_cumprod_on[sample.device] = self.alphas_cumprod.to(sample.device)
        a = table[timesteps.to(sample.device).long()]
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
    """DDIM sampling over a strided timestep grid: deterministic (eta = 0),
    as the pipeline runs it, or stochastic (JAX :158-197)."""

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
             num_inference_steps: int, eta: float = 0.0,
             noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One DDIM step from ``timestep``.  With ``eta > 0`` the step adds
        ``sigma * noise``, ``sigma = eta sqrt((1 - a_prev) / (1 - a_t) (1 -
        a_t / a_prev))``, and the direction term shrinks to ``sqrt(1 -
        a_prev - sigma^2) eps``.  JAX draws that noise from ``rng``; here it
        is given, shaped like ``sample``, and required when ``eta > 0``."""
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
        if eta > 0.0:
            if noise is None:
                raise ValueError("DDIM with eta > 0 needs its noise")
            sigma = eta * torch.sqrt((1.0 - a_prev) / (1.0 - a_t) * (1.0 - a_t / a_prev))
            prev = torch.sqrt(a_prev) * x0 + torch.sqrt(1.0 - a_prev - sigma ** 2) * eps
            prev = prev + sigma * noise.to(sample.dtype)
        else:
            prev = torch.sqrt(a_prev) * x0 + torch.sqrt(1.0 - a_prev) * eps
        return prev.to(sample.dtype)


def _t32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


class PNDMScheduler:
    """PNDM's PLMS path with ``skip_prk_steps`` (JAX :201-303), SD's default
    sampler: the first step plain, the second re-evaluates at the same t
    (midpoint), then the Adams-Bashforth ramp up to fourth order.  State:
    ``counter``, the eps history ``ets`` (latest last, up to 4) and
    ``cur_sample``."""

    ORDER = 4

    def __init__(self, config: SchedulerConfig = SchedulerConfig()):
        self.config = config
        self.alphas_cumprod = torch.tensor(np.cumprod(1.0 - config.betas()),
                                           dtype=torch.float32)
        self.final_alpha_cumprod = (torch.tensor(1.0) if config.set_alpha_to_one
                                    else self.alphas_cumprod[0])
        self.num_train_timesteps = config.num_train_timesteps

    def timesteps(self, num_inference_steps: int) -> torch.Tensor:
        """The DDIM grid with its second step repeated (int64)."""
        step = self.num_train_timesteps // num_inference_steps
        base = (np.arange(0, num_inference_steps) * step).round().astype(np.int64)
        base = base + self.config.steps_offset
        ts = np.concatenate([base[:-1], base[-2:-1], base[-1:]])[::-1]
        return torch.from_numpy(np.clip(ts, 0, self.num_train_timesteps - 1).copy())

    def init_state(self, sample: torch.Tensor, num_inference_steps: int) -> Dict[str, Any]:
        return {"counter": 0, "ets": [], "cur_sample": None}

    def step(self, model_output, timestep: int, sample, state, num_inference_steps: int):
        stride = self.num_train_timesteps // num_inference_steps
        counter, t = state["counter"], int(timestep)
        prev_t = t - stride
        if counter == 1:  # the second evaluation at the same t: the midpoint
            prev_t, t = t, t + stride
        ets = state["ets"] if counter == 1 else (state["ets"] + [model_output])[-self.ORDER:]
        n_hist = min(counter if counter >= 1 else counter + 1, 4)
        if counter == 0:
            eps = model_output
        elif counter == 1:
            eps = (ets[-1] + model_output) / 2
        elif n_hist == 2:
            eps = (3 * ets[-1] - ets[-2]) / 2
        elif n_hist == 3:
            eps = (23 * ets[-1] - 16 * ets[-2] + 5 * ets[-3]) / 12
        else:
            eps = (55 * ets[-1] - 59 * ets[-2] + 37 * ets[-3] - 9 * ets[-4]) / 24
        cur = state["cur_sample"] if counter == 1 else sample
        prev = self._prev_sample(cur, t, prev_t, eps)
        return prev, {"counter": counter + 1, "ets": ets,
                      "cur_sample": sample if counter == 0 else state["cur_sample"]}

    def _prev_sample(self, sample, t: int, prev_t: int, eps):
        a_t = self.alphas_cumprod[t]
        a_prev = self.alphas_cumprod[prev_t] if prev_t >= 0 else self.final_alpha_cumprod
        if self.config.prediction_type == "v_prediction":
            eps = torch.sqrt(a_t) * eps + torch.sqrt(1.0 - a_t) * sample
        sample_coeff = torch.sqrt(a_prev / a_t)
        denom = a_t * torch.sqrt(1.0 - a_prev) + torch.sqrt(a_t * a_prev * (1.0 - a_t))
        eps_coeff = (a_prev - a_t) / denom
        return sample_coeff * sample - eps_coeff * eps


class EulerDiscreteScheduler:
    """Euler in sigma space (JAX :306-385), deterministic.  The pipeline
    scales the initial N(0, 1) latents by :meth:`init_noise_sigma` and feeds
    the UNet :meth:`scale_model_input`; timesteps are floats."""

    stochastic = False

    def __init__(self, config: SchedulerConfig = SchedulerConfig(), karras: bool = False):
        self.config = config
        self.karras = karras
        ac = np.cumprod(1.0 - config.betas())
        self.alphas_cumprod = torch.tensor(ac, dtype=torch.float32)
        self.num_train_timesteps = config.num_train_timesteps
        self._sigma_table = np.sqrt((1.0 - ac) / ac)

    @property
    def spacing(self) -> str:
        """The grid's ``timestep_spacing`` (:class:`SpacedSchedulerConfig`)."""
        spacing = getattr(self.config, "timestep_spacing", "linspace")
        if spacing not in ("linspace", "leading"):
            raise ValueError(f"unsupported timestep_spacing {spacing!r}")
        return spacing

    def _grid_np(self, n: int) -> np.ndarray:
        if self.spacing == "leading":
            ratio = self.num_train_timesteps // n
            return (np.arange(n) * ratio).round()[::-1].astype(np.float64) + \
                self.config.steps_offset
        return np.linspace(0, self.num_train_timesteps - 1, n)[::-1].copy()

    def _sigmas_np(self, n: int) -> np.ndarray:
        """n sigmas and a final 0 (fp32); Karras: the rho-7 grid between the
        same end points."""
        sig = np.interp(self._grid_np(n), np.arange(self.num_train_timesteps),
                        self._sigma_table)
        if self.karras:
            rho = 7.0
            smax, smin = sig[0] ** (1 / rho), sig[-1] ** (1 / rho)
            sig = (smax + np.linspace(0.0, 1.0, n) * (smin - smax)) ** rho
        return np.append(sig, 0.0).astype(np.float32)

    def timesteps(self, num_inference_steps: int) -> torch.Tensor:
        """fp32; Karras: each sigma's t by log-linear interpolation."""
        if self.karras:
            sig = self._sigmas_np(num_inference_steps)[:-1]
            ts = np.interp(np.log(sig), np.log(self._sigma_table),
                           np.arange(self.num_train_timesteps))
            return torch.tensor(ts, dtype=torch.float32)
        return torch.tensor(self._grid_np(num_inference_steps), dtype=torch.float32)

    def init_noise_sigma(self, num_inference_steps: int) -> float:
        s = float(self._sigmas_np(num_inference_steps)[0])
        return s if self.spacing == "linspace" else float(np.sqrt(s * s + 1.0))

    def init_state(self, sample: torch.Tensor, num_inference_steps: int,
                   noise: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        return {"counter": 0, "sigmas": torch.from_numpy(self._sigmas_np(num_inference_steps))}

    def scale_model_input(self, sample, state, num_inference_steps: int):
        sig = state["sigmas"][state["counter"]]
        return (sample / torch.sqrt(sig ** 2 + 1.0)).to(sample.dtype)

    def _denoised(self, model_output, sample, sigma):
        """x0 from the unscaled (variance-exploding) sample."""
        if self.config.prediction_type == "epsilon":
            return sample - sigma * model_output
        if self.config.prediction_type == "v_prediction":
            return (-sigma / torch.sqrt(sigma ** 2 + 1.0)) * model_output + (
                sample / (sigma ** 2 + 1.0))
        raise ValueError(self.config.prediction_type)

    def step(self, model_output, timestep, sample, state, num_inference_steps: int):
        i, sigmas = state["counter"], state["sigmas"]
        sigma, sigma_next = sigmas[i], sigmas[i + 1]
        x0 = self._denoised(model_output, sample, sigma)
        d = (sample - x0) / sigma
        prev = sample + d * (sigma_next - sigma)
        return prev.to(sample.dtype), dict(state, counter=i + 1)


class EulerAncestralDiscreteScheduler(EulerDiscreteScheduler):
    """Ancestral Euler (JAX :388-430): noise added at every step but the
    last.  The JAX step draws it from each sample's key; here it is given:
    ``noise`` (steps, B, C, h, w), drawn per seed before the loop, so that a
    request's noise depends only on its seed."""

    stochastic = True

    def init_state(self, sample, num_inference_steps, noise=None):
        if noise is None:
            raise ValueError("Euler-ancestral needs its per-step noise")
        return dict(super().init_state(sample, num_inference_steps), noise=noise)

    def step(self, model_output, timestep, sample, state, num_inference_steps: int):
        i, sigmas = state["counter"], state["sigmas"]
        sigma, sigma_next = sigmas[i], sigmas[i + 1]
        x0 = self._denoised(model_output, sample, sigma)
        var = sigma_next ** 2 * (sigma ** 2 - sigma_next ** 2) / sigma ** 2
        sigma_up = torch.sqrt(torch.clamp(var, min=0.0))
        sigma_down = torch.sqrt(torch.clamp(sigma_next ** 2 - sigma_up ** 2, min=0.0))
        d = (sample - x0) / sigma
        prev = sample + d * (sigma_down - sigma)
        if float(sigma_next) > 0:  # no noise into the terminal sigma = 0
            prev = prev + sigma_up * state["noise"][i].to(prev.dtype)
        return prev.to(sample.dtype), dict(state, counter=i + 1)


class LMSDiscreteScheduler(EulerDiscreteScheduler):
    """Linear multistep up to order 4 (JAX :433-489): ``x += sum_j c_ij
    d_{i-j}`` with the Adams-Bashforth coefficients of the sigma grid (a
    numpy table at construction per step count)."""

    order = 4
    stochastic = False

    def _lms_coeffs_np(self, n: int) -> np.ndarray:
        """(steps, order): row i holds c_ij for j = 0 (the current d) .. 3,
        zero while the history ramps up."""
        sig = self._sigmas_np(n).astype(np.float64)
        coeffs = np.zeros((len(sig) - 1, self.order), np.float64)
        for i in range(len(sig) - 1):
            cur_order = min(i + 1, self.order)
            for j in range(cur_order):
                poly = np.poly1d([1.0])
                for k in range(cur_order):
                    if k == j:
                        continue
                    denom = sig[i - j] - sig[i - k]
                    poly *= np.poly1d([1.0 / denom, -sig[i - k] / denom])
                anti = poly.integ()
                coeffs[i, j] = anti(sig[i + 1]) - anti(sig[i])
        return coeffs.astype(np.float32)

    def init_state(self, sample, num_inference_steps, noise=None):
        return dict(super().init_state(sample, num_inference_steps), d_hist=[],
                    coeffs=torch.from_numpy(self._lms_coeffs_np(num_inference_steps)))

    def step(self, model_output, timestep, sample, state, num_inference_steps: int):
        i, sigmas = state["counter"], state["sigmas"]
        sigma = sigmas[i]
        x0 = self._denoised(model_output, sample, sigma)
        d = ((sample - x0) / sigma).to(sample.dtype)
        c = state["coeffs"][i]
        prev = sample + c[0] * d
        for j, dj in enumerate(state["d_hist"], start=1):  # most recent first
            prev = prev + c[j] * dj
        d_hist = ([d] + state["d_hist"])[: self.order - 1]
        return prev.to(sample.dtype), dict(state, counter=i + 1, d_hist=d_hist)


class DPMSolverMultistepScheduler:
    """DPM-Solver++(2M) in x0 form (JAX :492-605): first order on the first
    step and on the last one into the terminal boundary, second order with
    the previous x0 in between; the linspace grid reaches t = T-1."""

    def __init__(self, config: SchedulerConfig = SchedulerConfig()):
        self.config = config
        ac = np.cumprod(1.0 - config.betas())
        self.alphas_cumprod = torch.tensor(ac, dtype=torch.float32)
        self.num_train_timesteps = config.num_train_timesteps
        alpha, sigma = np.sqrt(ac), np.sqrt(1.0 - ac)
        self.alpha_t = torch.tensor(alpha, dtype=torch.float32)
        self.sigma_t = torch.tensor(sigma, dtype=torch.float32)
        self.lambda_t = torch.tensor(np.log(alpha) - np.log(sigma), dtype=torch.float32)
        self.final_alpha_cumprod = (torch.tensor(1.0) if config.set_alpha_to_one
                                    else self.alphas_cumprod[0])

    def _timesteps_np(self, num_inference_steps: int) -> np.ndarray:
        return (np.linspace(0, self.num_train_timesteps - 1, num_inference_steps + 1)
                .round()[::-1][:-1].astype(np.int64))

    def timesteps(self, num_inference_steps: int) -> torch.Tensor:
        return torch.from_numpy(self._timesteps_np(num_inference_steps).copy())

    def _prev_timesteps_np(self, num_inference_steps: int) -> np.ndarray:
        ts = self._timesteps_np(num_inference_steps)
        return np.append(ts[1:], -1)  # -1: the terminal boundary

    def init_state(self, sample: torch.Tensor, num_inference_steps: int) -> Dict[str, Any]:
        return {"counter": 0, "prev_x0": torch.zeros_like(sample),
                "prev_lambda": torch.zeros((), dtype=torch.float32),
                "prev_t": self._prev_timesteps_np(num_inference_steps)}

    def _x0(self, model_output, sample, t: int):
        a, s = self.alpha_t[t], self.sigma_t[t]
        if self.config.prediction_type == "epsilon":
            return (sample - s * model_output) / a
        if self.config.prediction_type == "v_prediction":
            return a * sample - s * model_output
        raise ValueError(self.config.prediction_type)

    def _at_prev(self, prev_t: int):
        a_prev = self.alphas_cumprod[prev_t] if prev_t >= 0 else self.final_alpha_cumprod
        alpha = torch.sqrt(a_prev)
        sigma = torch.sqrt(torch.clamp(1.0 - a_prev, min=1e-12))
        return alpha, sigma, torch.log(alpha) - torch.log(sigma)

    def step(self, model_output, timestep, sample, state, num_inference_steps: int):
        table, counter, t = state["prev_t"], state["counter"], int(timestep)
        prev_t = int(table[min(counter, len(table) - 1)])
        x0 = self._x0(model_output, sample, t)
        if self.config.clip_sample:
            x0 = x0.clamp(-1.0, 1.0)
        lam_s, sigma_s = self.lambda_t[t], self.sigma_t[t]
        alpha_p, sigma_p, lam_p = self._at_prev(prev_t)
        h = lam_p - lam_s
        em1 = torch.expm1(-h)
        x_first = (sigma_p / sigma_s) * sample - alpha_p * em1 * x0
        if counter == 0 or prev_t < 0:
            prev = x_first
        else:
            h_prev = lam_s - state["prev_lambda"]
            r = h_prev / (h if float(h) != 0 else torch.ones(()))
            d1 = (x0 - state["prev_x0"]) / (r if float(r) != 0 else torch.ones(()))
            prev = x_first - 0.5 * alpha_p * em1 * d1
        new_state = dict(state, counter=counter + 1, prev_lambda=lam_s,
                         prev_x0=x0.to(state["prev_x0"].dtype))
        return prev.to(sample.dtype), new_state


SIGMA_SAMPLERS = {"euler": EulerDiscreteScheduler,
                  "euler_a": EulerAncestralDiscreteScheduler,
                  "lms": LMSDiscreteScheduler}


def txt2img_scheduler(scheduler: str, config: SchedulerConfig):
    """The sampler a txt2img request names (JAX pipeline :575-609): ddim,
    pndm, dpm, or euler / euler_a / lms with an optional ``:karras``."""
    base, _, variant = scheduler.partition(":")
    karras = variant == "karras"
    if variant and not karras:
        raise ValueError(f"unknown scheduler variant {scheduler!r}")
    if karras and base not in SIGMA_SAMPLERS:
        raise ValueError(f"{base} does not support the karras grid")
    if base == "ddim":
        return DDIMScheduler(config)
    if base == "pndm":
        return PNDMScheduler(config)
    if base == "dpm":
        return DPMSolverMultistepScheduler(config)
    if base in SIGMA_SAMPLERS:
        return SIGMA_SAMPLERS[base](config, karras=karras)
    raise ValueError(f"unknown scheduler {scheduler}")


def img2img_scheduler(scheduler: str, config: SchedulerConfig):
    """The sampler an img2img request names, on its whole grid, with the
    errors of JAX's ``_build_img2img_fn`` (pipeline :808-865);
    :func:`restart_on_tail` then restarts it where the request starts."""
    base, _, variant = scheduler.partition(":")
    karras = variant == "karras"
    if variant and not karras:
        raise ValueError(f"unknown scheduler variant {scheduler!r}")
    sigma_space = base in SIGMA_SAMPLERS
    if karras and not sigma_space:
        raise ValueError(f"{base} does not support the karras grid")
    if base == "ddim":
        return DDIMScheduler(config)
    if base == "pndm":
        return PNDMScheduler(config)
    if base == "dpm":
        return DPMSolverMultistepScheduler(config)
    if sigma_space:
        return SIGMA_SAMPLERS[base](config, karras=karras)
    raise ValueError("img2img supports ddim / pndm / dpm / euler / euler_a / lms "
                     f"(got {scheduler!r})")


def restart_on_tail(sampler, num_steps: int, start: int):
    """``sampler`` restarted at step ``start`` of its ``num_steps`` grid, as
    JAX's img2img restarts it (pipeline :788-865): its grid methods answer
    the tail ``[start:]`` of that grid whatever step count they are asked
    for, and its state starts fresh there.  DDIM and PNDM run the tail as it
    is (PNDM's counter ramps from 0, diffusers' counter-based PLMS
    warm-up); DPM-Solver++ solves afresh on the sub-grid (its per-n tables
    sliced); the sigma-space samplers start on the sliced sigmas, the
    k-diffusion convention (LMS's history ramps from scratch, the first
    sigma the start's), rather than pretending the skipped steps ran."""
    if isinstance(sampler, DPMSolverMultistepScheduler):
        grids = ("_timesteps_np",)
    elif isinstance(sampler, EulerDiscreteScheduler):
        grids = ("_sigmas_np", "timesteps")
    else:
        return sampler
    full = copy.copy(sampler)  # keeps the class's grid methods
    for name in grids:
        setattr(sampler, name, lambda _n, grid=getattr(full, name): grid(num_steps)[start:])
    return sampler
