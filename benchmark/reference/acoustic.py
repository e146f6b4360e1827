"""The plain MixGAN-TTS generator in shallow mode: linguistic encoder,
FFT decoder, mel_linear and PostNet (the coarse mel), and one shallow
diffusion step through the 20-block gated residual denoiser.

Synthesis makes three kinds of discrete decision from continuous values:
the pitch and energy bins (`torch.bucketize`) and the rounded frames per
word.  Two float32 computations of one value may fall on either side of an
edge.  So `encode` takes the decisions of the program under test where they
are given (`Decisions`), and returns beside its output how far its own
values lie outside the intervals those decisions stand for
(`decision_gap`): the program's decisions are judged, and then followed,
as a served model's tokens are.

The denoiser's residual stack runs in the kernels' arithmetic of `arith`
(`Arith.operand` rounds y and g; the products are summed in float32, the
biases, y0, the residual and the skip sum stay float32), as the program's
bf16 tensor-core kernel computes them.  Training runs the blocks in
float32, as the program's training does.
"""

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .arith import FULL
from .blocks import (
    ConvNorm, Decoder, LinearNorm, Mish, PostNet, RelativeFFTBlock, VariancePredictor,
    WordToPhonemeAttention, diffusion_embedding, length_regulate, mapping_mask,
    rel_position_coef, sequence_mask, sinusoid_position_table, word_pooling,
)


class Decisions(NamedTuple):
    """The program's discrete decisions for one batch: its pitch and
    energy predictions [B, P] (bucketized here with this reference's own
    bins) and its frames per word [B, W]."""
    pitch: torch.Tensor
    energy: torch.Tensor
    dur_w: torch.Tensor


class Encoded(NamedTuple):
    features: torch.Tensor
    mel_mask: torch.Tensor
    mel_len: torch.Tensor
    gap: float                   # decision_gap of the program's decisions (0 without)
    decisions: Decisions         # this reference's own pitch and energy, and the frames used


def _bins(lo, hi, n_bins):
    return torch.tensor(np.linspace(lo, hi, n_bins - 1), dtype=torch.float32)


def _bin_gap(v, chosen, bins):
    """How far v lies outside [bins[chosen - 1], bins[chosen]) in bin
    widths (bucketize's right=True intervals; the end bins are open)."""
    width = bins[1] - bins[0]
    n = bins.shape[0]
    lo = torch.where(chosen > 0, bins[torch.clamp(chosen - 1, 0, n - 1)],
                     torch.full_like(v, -math.inf))
    hi = torch.where(chosen < n, bins[torch.clamp(chosen, 0, n - 1)],
                     torch.full_like(v, math.inf))
    return torch.clamp(torch.maximum(lo - v, v - hi), min=0.0) / width


def _dur_gap(v, chosen):
    """How far v lies outside the values that round to `chosen` frames
    (clamped at 0), in frames."""
    lo = torch.where(chosen > 0, chosen.float() - 0.5, torch.full_like(v, -math.inf))
    return torch.clamp(torch.maximum(lo - v, v - (chosen.float() + 0.5)), min=0.0)


class LinguisticEncoder(nn.Module):
    def __init__(self, cfg, stats):
        super().__init__()
        t, v, ve = cfg["transformer"], cfg["variance_predictor"], cfg["variance_embedding"]
        H = t["encoder_hidden"]
        n_bins = ve["n_bins"]
        self.src_emb = nn.Embedding(cfg["n_symbols"] + 1, H)
        self.phoneme_encoder = RelativeFFTBlock(H, t["encoder_head"], t["encoder_layer"],
                                                t["conv_kernel_size"], t["encoder_window_size"],
                                                t["encoder_dropout"])
        self.word_encoder = RelativeFFTBlock(H, t["encoder_head"], t["encoder_layer"],
                                             t["conv_kernel_size"], t["encoder_window_size"],
                                             t["encoder_dropout"])
        args = (H, v["filter_size"], v["kernel_size"], v["dropout"])
        self.duration_predictor = VariancePredictor(*args)
        self.pitch_predictor = VariancePredictor(*args)
        self.energy_predictor = VariancePredictor(*args)
        self.pitch_embedding = nn.Embedding(n_bins, H)
        self.energy_embedding = nn.Embedding(n_bins, H)
        table = torch.from_numpy(sinusoid_position_table(cfg["max_seq_len"] + 1, H))[None]
        self.q_position_enc = nn.Parameter(table.clone())
        self.kv_position_enc = nn.Parameter(table.clone())
        self.w2p_attn = WordToPhonemeAttention(t["encoder_head"], H)
        self.register_buffer("pitch_bins", _bins(stats["pitch_min"], stats["pitch_max"], n_bins),
                             persistent=False)
        self.register_buffer("energy_bins",
                             _bins(stats["energy_min"], stats["energy_max"], n_bins),
                             persistent=False)

    def forward(self, texts, src_lens, wb, src_w_lens, max_mel_len, mel_lens=None,
                attn_prior=None, pitch_target=None, energy_target=None, duration_target=None,
                decisions: Optional[Decisions] = None):
        B, P = texts.shape
        W = wb.shape[1]
        src_mask = sequence_mask(src_lens, P)
        src_w_mask = sequence_mask(src_w_lens, W)
        emb = self.src_emb(texts) * (texts > 0)[..., None]
        enc_p = self.phoneme_encoder(emb, src_mask[..., None].float())
        gaps = []

        def bin_of(pred, target, bins, given):
            if target is not None:
                return torch.bucketize(target, bins, right=True)
            own = torch.bucketize(pred, bins, right=True)
            if given is None:
                return own
            chosen = torch.bucketize(given, bins, right=True)
            gaps.append(_bin_gap(pred, chosen, bins)[src_mask])
            return chosen

        pitch = self.pitch_predictor(enc_p, src_mask)
        enc_p = enc_p + self.pitch_embedding(bin_of(
            pitch, pitch_target, self.pitch_bins, decisions and decisions.pitch))
        energy = self.energy_predictor(enc_p, src_mask)
        enc_p = enc_p + self.energy_embedding(bin_of(
            energy, energy_target, self.energy_bins, decisions and decisions.energy))

        enc_w = self.word_encoder(word_pooling(enc_p, wb, W, "mean"), src_w_mask[..., None].float())
        log_dur_p = self.duration_predictor(enc_p, src_mask)
        dur_w_sum = word_pooling(torch.exp(log_dur_p)[..., None], wb, W, "sum")[..., 0]
        log_dur_w = torch.log(torch.clamp(dur_w_sum, min=1e-8)) * src_w_mask
        if duration_target is not None:
            dur_w = torch.round(word_pooling(duration_target[..., None].float(), wb, W,
                                             "sum")[..., 0]).long()
        else:
            value = torch.exp(log_dur_w) - 1
            dur_w = torch.clamp(torch.round(value), min=0).long() * src_w_mask
            if decisions is not None:
                dur_w = decisions.dur_w.long()
                gaps.append(_dur_gap(value, dur_w)[src_w_mask])
        x, mel_len = length_regulate(enc_w, dur_w, max_mel_len)
        mel_len = torch.clamp(mel_len, max=max_mel_len)
        mel_mask = (sequence_mask(mel_lens, max_mel_len) if mel_lens is not None
                    else sequence_mask(mel_len, max_mel_len))

        map_mask = mapping_mask(dur_w, wb, max_mel_len, P, W)
        q_coef = rel_position_coef(dur_w, max_mel_len, mel_mask)
        kv_coef = rel_position_coef(wb, P, src_mask)
        q = x + q_coef[..., None] * self.q_position_enc[:, :max_mel_len]
        k = enc_p + kv_coef[..., None] * self.kv_position_enc[:, :P]
        features = self.w2p_attn(q, k, k, src_mask, mel_mask, map_mask, attn_prior)
        gap = float(torch.cat(gaps).max()) if gaps and sum(g.numel() for g in gaps) else 0.0
        return Encoded(features, mel_mask, mel_len, gap, Decisions(pitch, energy, dur_w))


# --- the denoiser ------------------------------------------------------------------

class ResidualBlock(nn.Module):
    def __init__(self, d_encoder, C):
        super().__init__()
        self.conv_layer = ConvNorm(C, 2 * C, 3)
        self.diffusion_projection = LinearNorm(C, C)
        self.conditioner_projection = ConvNorm(d_encoder, C, 1)
        self.output_projection = ConvNorm(C, 2 * C, 1)

    def forward(self, x, cond, step_emb):
        y0 = x + self.diffusion_projection(step_emb)[:, None, :]
        y = y0 + self.conditioner_projection(cond)
        gate, filt = self.conv_layer(y).chunk(2, dim=-1)
        out, skip = self.output_projection(torch.sigmoid(gate) * torch.tanh(filt)).chunk(2, dim=-1)
        return (out + y0) / math.sqrt(2.0), skip

    def kernel_forward(self, x, condp, step_proj, arith):
        """The block as the kernels compute it: y and g rounded to the
        operand type, products summed in fp32, biases after each product."""
        C = x.shape[-1]
        w_conv = arith.operand(self.conv_layer.conv.weight)
        w_out = arith.operand(self.output_projection.conv.weight[:, :, 0])
        y0 = x + step_proj[:, None, :]
        y = arith.operand(y0 + condp)
        z = F.conv1d(y.transpose(1, 2), w_conv, padding=1).transpose(1, 2)
        z = z + self.conv_layer.conv.bias
        g = arith.operand(torch.sigmoid(z[..., :C]) * torch.tanh(z[..., C:]))
        o = g @ w_out.t() + self.output_projection.conv.bias
        return (o[..., :C] + y0) * (1.0 / math.sqrt(2.0)), o[..., C:]


class Denoiser(nn.Module):
    def __init__(self, n_mels, d_encoder, C, n_layers):
        super().__init__()
        self.C = C
        self.input_projection = nn.Sequential(ConvNorm(n_mels, C, 1), nn.ReLU())
        self.mlp = nn.Sequential(LinearNorm(C, 4 * C), Mish(), LinearNorm(4 * C, C))
        self.residual_layers = nn.ModuleList(ResidualBlock(d_encoder, C)
                                             for _ in range(n_layers))
        self.skip_projection = ConvNorm(C, C, 1)
        self.output_projection = ConvNorm(C, n_mels, 1)

    def forward(self, x_t, t, cond, arith=None):
        """x0 prediction.  With `arith` the residual stack runs in the
        kernels' arithmetic (synthesis); without, block by block in fp32
        (training)."""
        x = self.input_projection(x_t)
        step_emb = self.mlp(diffusion_embedding(t, self.C))
        skip_sum = 0
        for block in self.residual_layers:
            if arith is None:
                x, skip = block(x, cond, step_emb)
            else:
                condp = block.conditioner_projection(cond)
                step_proj = block.diffusion_projection(step_emb)
                x, skip = block.kernel_forward(x, condp, step_proj, arith)
            skip_sum = skip_sum + skip
        x = skip_sum / math.sqrt(len(self.residual_layers))
        return self.output_projection(F.relu(self.skip_projection(x)))


def vpsde_betas(timesteps, min_beta, max_beta):
    t = np.arange(1, timesteps + 1)
    t_coef = (2 * t - 1) / (timesteps ** 2)
    return 1.0 - np.exp(-min_beta / timesteps - 0.5 * (max_beta - min_beta) * t_coef)


class Diffusion(nn.Module):
    """The Gaussian diffusion's tables (float64, cast to float32) and the
    denoiser under the published key `denoise_fn`."""

    def __init__(self, denoise_fn, betas, spec_min, spec_max):
        super().__init__()
        self.denoise_fn = denoise_fn
        self.num_timesteps = len(betas)
        betas = np.asarray(betas, dtype=np.float64)
        ac = np.cumprod(1.0 - betas)
        ac_prev = np.append(1.0, ac[:-1])
        post_var = betas * (1.0 - ac_prev) / (1.0 - ac)
        tables = {
            "sqrt_ac": np.sqrt(ac), "sqrt_1m_ac": np.sqrt(1.0 - ac),
            "post_log_var": np.log(np.maximum(post_var, 1e-20)),
            "coef1": betas * np.sqrt(ac_prev) / (1.0 - ac),
            "coef2": (1.0 - ac_prev) * np.sqrt(1.0 - betas) / (1.0 - ac),
        }
        for name, v in tables.items():
            self.register_buffer(name, torch.tensor(v, dtype=torch.float32), persistent=False)
        self.register_buffer("spec_min", torch.tensor(spec_min, dtype=torch.float32),
                             persistent=False)
        self.register_buffer("spec_max", torch.tensor(spec_max, dtype=torch.float32),
                             persistent=False)

    def norm(self, x):
        return (x - self.spec_min) / (self.spec_max - self.spec_min) * 2.0 - 1.0

    def denorm(self, x):
        return (x + 1.0) / 2.0 * (self.spec_max - self.spec_min) + self.spec_min

    def _at(self, name, t):
        return getattr(self, name)[t][:, None, None]

    def diffuse(self, mel, t, noise):
        x0 = self.norm(mel)
        out = self._at("sqrt_ac", torch.clamp(t, min=0)) * x0 + self._at(
            "sqrt_1m_ac", torch.clamp(t, min=0)) * noise
        return torch.where((t < 0)[:, None, None], x0, out)

    def posterior_sample(self, x0, x_t, t, noise):
        mean = self._at("coef1", t) * x0 + self._at("coef2", t) * x_t
        nonzero = (t > 0).to(x_t.dtype)[:, None, None]
        return mean + nonzero * torch.exp(0.5 * self._at("post_log_var", t)) * noise


class TrainOut(NamedTuple):
    mel_mask: torch.Tensor
    coarse_mel: torch.Tensor        # detached toward the diffusion branch
    postnet_output: torch.Tensor    # keeps its gradient
    x0_pred: torch.Tensor
    x_ts: torch.Tensor
    x_t_prevs: torch.Tensor
    x_t_prev_preds: torch.Tensor
    t: torch.Tensor


class Synthesized(NamedTuple):
    features: torch.Tensor
    coarse_mel: torch.Tensor
    mel: torch.Tensor               # raw-scale, masked
    mel_mask: torch.Tensor
    mel_len: torch.Tensor
    decision_gap: float
    decisions: Decisions


class Generator(nn.Module):
    """MixGAN-TTS in shallow mode (single speaker)."""

    def __init__(self, cfg, stats):
        super().__init__()
        t, d = cfg["transformer"], cfg["denoiser"]
        H = t["encoder_hidden"]
        self.n_mels = cfg["n_mels"]
        self.linguistic_encoder = LinguisticEncoder(cfg, stats)
        self.decoder = Decoder(H, t["decoder_layer"], t["decoder_head"], t["conv_filter_size"],
                               t["conv_kernel_size"], cfg["max_seq_len"], t["decoder_dropout"])
        self.mel_linear = nn.Linear(H, self.n_mels)
        self.postnet = PostNet(n_mels=self.n_mels)
        betas = vpsde_betas(d["shallow_timesteps"], d["min_beta"], d["max_beta"])
        self.diffusion = Diffusion(
            Denoiser(self.n_mels, H, d["residual_channels"], d["residual_layers"]), betas,
            stats["spec_min"][:self.n_mels], stats["spec_max"][:self.n_mels])

    def coarse(self, features, mel_mask, update_stats=True):
        coarse = self.mel_linear(self.decoder(features, mel_mask))
        return coarse + self.postnet(coarse, update_stats=update_stats)

    def synthesize(self, texts, src_lens, wb, src_w_lens, T, start_noise, step_noises,
                   decisions=None, arith=FULL):
        """The inference path of one batch at frame bucket T, with the
        noise the program drew (`start_noise` [B, T, M], `step_noises`
        [S, B, T, M])."""
        enc = self.linguistic_encoder(texts, src_lens, wb, src_w_lens, T, decisions=decisions)
        coarse = self.coarse(enc.features, enc.mel_mask)
        maskf = enc.mel_mask[..., None].float()
        diff = self.diffusion
        B = texts.shape[0]
        t_last = torch.full((B,), diff.num_timesteps - 1, dtype=torch.long, device=texts.device)
        x = diff.diffuse(coarse, t_last, start_noise) * maskf
        for k, i in enumerate(reversed(range(diff.num_timesteps))):
            t = torch.full((B,), i, dtype=torch.long, device=texts.device)
            x0 = torch.clamp(diff.denoise_fn(x, t, enc.features, arith), -1.0, 1.0)
            x = diff.posterior_sample(x0, x, t, step_noises[k])
        mel = diff.denorm(x) * maskf
        return Synthesized(enc.features, coarse, mel, enc.mel_mask, enc.mel_len, enc.gap,
                           enc.decisions)

    def train_forward(self, batch, draw, update_stats=True):
        """The training branch: teacher-forced encoder, then one random
        diffusion step per utterance.  `draw(kind, shape)` gives t
        ("t", [B]) and the noises ("noise", [B, T, M]) in the program's
        order."""
        mels = batch["mels"]
        T = mels.shape[1]
        enc = self.linguistic_encoder(
            batch["texts"], batch["src_lens"], batch["word_boundaries"], batch["src_w_lens"], T,
            mel_lens=batch["mel_lens"], attn_prior=batch["attn_priors"],
            pitch_target=batch["p_targets"], energy_target=batch["e_targets"],
            duration_target=batch["d_targets"])
        coarse = self.coarse(enc.features, enc.mel_mask, update_stats)
        maskf = enc.mel_mask[..., None].float()
        diff = self.diffusion
        t = draw("t", (mels.shape[0],))
        x_ts = diff.diffuse(mels, t, draw("noise", mels.shape)) * maskf
        x_t_prevs = diff.diffuse(mels, t - 1, draw("noise", mels.shape)) * maskf
        x0 = diff.denoise_fn(x_ts, t, enc.features.detach())
        x0 = torch.clamp(x0 * maskf, -1.0, 1.0)
        x_t_prev_preds = diff.posterior_sample(
            diff.norm(coarse.detach()), x_ts, t, draw("noise", mels.shape)) * maskf
        return TrainOut(enc.mel_mask, coarse.detach(), coarse, x0, x_ts, x_t_prevs,
                        x_t_prev_preds, t)
