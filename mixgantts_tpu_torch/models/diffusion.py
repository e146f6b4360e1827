"""Gaussian diffusion with few-step sampling
(`mixgantts_tpu/models/diffusion.py`): the forward process training draws
from (`diffuse`, `q_posterior_sample`, aux mode's `diffuse_trace`) and the
reverse process of inference (`sampling`).

The reference's key layout puts the denoiser at `diffusion.denoise_fn`.
The coefficient tables are built in float64 from the beta schedule, cast to
float32, and kept as non-persistent buffers.  Noise is always passed in, or
drawn from an explicit `torch.Generator`.  Mels are [B, T, n_mels].

Each reverse step of `sampling` is a span, `diffusion.step` (one a shallow
call, `timesteps` a naive one), and counts in `reverse_steps`; training's
branch samples no reverse step and counts none.
"""

import numpy as np
import torch
import torch.nn as nn

from ..ops.schedules import get_noise_schedule_list
from ..parallel.collectives import global_rows
from ..utils.profiling import span


def schedule_betas(denoiser_config, mode):
    """The beta schedule of a model.yaml `denoiser` section for a mode."""
    d = denoiser_config
    timesteps = d["timesteps"] if mode == "naive" else d["shallow_timesteps"]
    return get_noise_schedule_list(d["noise_schedule_naive"], timesteps,
                                   d["min_beta"], d["max_beta"], d["s"])


def _tables(betas):
    betas = np.asarray(betas, dtype=np.float64)
    alphas_cumprod = np.cumprod(1.0 - betas)
    alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
    posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
    return {
        "sqrt_alphas_cumprod": np.sqrt(alphas_cumprod),
        "sqrt_one_minus_alphas_cumprod": np.sqrt(1.0 - alphas_cumprod),
        "posterior_log_variance_clipped": np.log(np.maximum(posterior_variance, 1e-20)),
        "posterior_mean_coef1": betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod),
        "posterior_mean_coef2": ((1.0 - alphas_cumprod_prev) * np.sqrt(1.0 - betas)
                                 / (1.0 - alphas_cumprod)),
    }


class GaussianDiffusion(nn.Module):
    def __init__(self, denoise_fn, betas, spec_min, spec_max):
        super().__init__()
        self.denoise_fn = denoise_fn
        self.num_timesteps = len(betas)
        for name, table in _tables(betas).items():
            self.register_buffer(name, torch.tensor(table, dtype=torch.float32),
                                 persistent=False)
        self.register_buffer("spec_min", torch.tensor(spec_min, dtype=torch.float32),
                             persistent=False)
        self.register_buffer("spec_max", torch.tensor(spec_max, dtype=torch.float32),
                             persistent=False)
        self.reverse_steps = 0

    # --- mel normalisation ([spec_min, spec_max] <-> [-1, 1]) --------------

    def norm_spec(self, x):
        return (x - self.spec_min) / (self.spec_max - self.spec_min) * 2.0 - 1.0

    def denorm_spec(self, x):
        return (x + 1.0) / 2.0 * (self.spec_max - self.spec_min) + self.spec_min

    # --- forward process ----------------------------------------------------

    def _extract(self, name, t):
        return getattr(self, name)[t][:, None, None]

    def q_sample(self, x0, t, noise):
        return (self._extract("sqrt_alphas_cumprod", t) * x0
                + self._extract("sqrt_one_minus_alphas_cumprod", t) * noise)

    def diffuse(self, mel, t, noise):
        """Normalise a raw mel and diffuse it to step t; t == -1 returns the
        normalised mel."""
        x0 = self.norm_spec(mel)
        out = self.q_sample(x0, torch.clamp(t, min=0), noise)
        return torch.where((t < 0)[:, None, None], x0, out)

    def q_posterior_sample(self, x0, x_t, t, noise):
        """Sample q(x_{t-1} | x_t, x_0); no noise at t == 0."""
        mean = (self._extract("posterior_mean_coef1", t) * x0
                + self._extract("posterior_mean_coef2", t) * x_t)
        log_var = self._extract("posterior_log_variance_clipped", t)
        nonzero = (t > 0).to(x_t.dtype)[:, None, None]
        return mean + nonzero * torch.exp(0.5 * log_var) * noise

    # --- inference ----------------------------------------------------------

    def sampling(self, cond, spk_emb, noise, step_noises, return_trace=False):
        """Reverse process from `noise` (x_T [B, T, n_mels]) to the
        normalised x0, conditioned on cond [B, T, H] and a multi-speaker
        model's speaker embedding spk_emb [B, H]; `step_noises` [S, B, T,
        n_mels] are the per-step posterior noises, consumed t = S-1 .. 0
        (`MixGANTTS.inference_noise` draws both).  With `return_trace`, the
        whole trajectory x_T .. x_0 [S+1, B, T, n_mels]."""
        B = cond.shape[0]
        x = noise
        trace = [x]
        for k, i in enumerate(reversed(range(self.num_timesteps))):
            with span("diffusion.step"):
                t = torch.full((B,), i, dtype=torch.long, device=cond.device)
                x0_pred = torch.clamp(self.denoise_fn(x, t, cond, spk_emb), -1.0, 1.0)
                x = self.q_posterior_sample(x0_pred, x, t, step_noises[k])
            self.reverse_steps += 1
            trace.append(x)
        return torch.stack(trace) if return_trace else x

    def diffuse_trace(self, mel, mel_mask, generator=None, noises=None):
        """[S+1, B, T, n_mels]: the clamped normalised mel, then its
        diffusion at t = 0 .. S-1, all masked (aux mode's output).
        `noises` [S, B, T, n_mels] injects the noise of each step; drawn
        noise is drawn for the global batch under data parallelism."""
        maskf = mel_mask[..., None].to(mel.dtype)
        trace = [torch.clamp(self.norm_spec(mel), -1.0, 1.0) * maskf]
        for i in range(self.num_timesteps):
            noise = noises[i] if noises is not None else global_rows(
                lambda shape: torch.randn(shape, generator=generator, device=mel.device),
                mel.shape)
            t = torch.full((mel.shape[0],), i, dtype=torch.long, device=mel.device)
            trace.append(self.diffuse(mel, t, noise) * maskf)
        return torch.stack(trace)
