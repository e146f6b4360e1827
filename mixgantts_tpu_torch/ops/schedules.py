"""Diffusion noise schedules (`mixgantts_tpu/ops/schedules.py`), in numpy."""

import numpy as np


def vpsde_beta_t(t, T, min_beta, max_beta):
    t_coef = (2 * t - 1) / (T ** 2)
    return 1.0 - np.exp(-min_beta / T - 0.5 * (max_beta - min_beta) * t_coef)


def get_noise_schedule_list(schedule_mode, timesteps, min_beta=0.0,
                            max_beta=0.01, s=0.008):
    if schedule_mode == "linear":
        return np.linspace(1e-4, max_beta, timesteps)
    if schedule_mode == "cosine":
        steps = timesteps + 1
        x = np.linspace(0, steps, steps)
        alphas_cumprod = np.cos(((x / steps) + s) / (1 + s) * np.pi * 0.5) ** 2
        alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
        betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
        return np.clip(betas, a_min=0, a_max=0.999)
    if schedule_mode == "vpsde":
        return np.array([
            vpsde_beta_t(t, timesteps, min_beta, max_beta)
            for t in range(1, timesteps + 1)
        ])
    raise NotImplementedError(schedule_mode)
