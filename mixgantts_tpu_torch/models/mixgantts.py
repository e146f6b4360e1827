"""MixGAN-TTS generator (`mixgantts_tpu/models/mixgantts.py`).

Linguistic encoder -> (aux, shallow: FFT decoder + mel_linear + PostNet ->
coarse mel) -> Gaussian diffusion.  The three modes:
- naive: `num_timesteps` reverse steps from Gaussian noise;
- shallow: the coarse mel diffused to the last step, then the reverse
  steps (one for LJSpeech);
- aux: no reverse process; `mel_pred` is the diffuse trace
  [S+1, B, T, n_mels] whose element 0 is the clamped normalised coarse mel.

A multi-speaker model embeds the speaker with a table (`n_speakers` rows,
speaker embedder "none") or projects an external embedding (`spker_embeds`
[B, external_speaker_dim], e.g. DeepSpeaker's), under the reference's one
key `speaker_emb`; the embedding conditions the denoiser only, as in the
JAX package.

Given target `mels`, the forward is the training branch: teacher-forced
encoder, and in naive and shallow modes one random diffusion step t per
utterance, giving the discriminator's pairs (x_t, x_{t-1}) and (x_t, the
posterior sample around the predicted x0, or around the coarse mel in
shallow mode).  Shallow mode freezes the aux stack toward the diffusion
branch by detaching what it feeds it, where the JAX package stops the
gradient; the PostNet output keeps its gradient for the postnet loss.
Dropout and the PostNet's BatchNorm follow the module's training mode.

Randomness comes from `noise_override` or from an explicit
`torch.Generator`.  Keys: inference {"start_noise": [B, T, M],
"step_noises": [S, B, T, M]}; training {"t": [B], "x_t_noise",
"x_t_prev_noise", "posterior_noise": [B, T, M]}, and aux mode's
{"trace_noises": [S, B, T, M]}.
"""

from typing import NamedTuple, Optional

import torch
import torch.nn as nn

from ..ops import sequence_mask
from ..utils.tools import resolve_device
from .aux_decoder import Decoder, PostNet
from .denoiser import Denoiser
from .diffusion import GaussianDiffusion, schedule_betas
from .linguistic_encoder import LinguisticEncoder


class GeneratorOutput(NamedTuple):
    mel_pred: torch.Tensor                 # inference: [B, T, M] raw-scale mel
    #                                        ([S+1, B, T, M] with return_trace);
    #                                        training: normalised x0 prediction;
    #                                        aux: the trace [S+1, B, T, M]
    mel_lens: torch.Tensor                 # [B]
    mel_mask: torch.Tensor                 # [B, T] bool, True = valid
    coarse_mel: Optional[torch.Tensor]     # [B, T, M] PostNet output (aux, shallow)
    pitch_pred: torch.Tensor               # [B, P]
    energy_pred: torch.Tensor              # [B, P]
    log_dur_w_pred: torch.Tensor           # [B, W]
    dur_w_rounded: torch.Tensor            # [B, W]
    x_ts: Optional[torch.Tensor]           # training: [B, T, M] normalised, masked
    x_t_prevs: Optional[torch.Tensor]
    x_t_prev_preds: Optional[torch.Tensor]
    diffusion_step: Optional[torch.Tensor]  # training: t [B]
    speaker_emb: Optional[torch.Tensor]    # [B, H] (multi-speaker)
    src_mask: torch.Tensor                 # [B, P] bool
    src_w_mask: torch.Tensor               # [B, W] bool
    src_lens: torch.Tensor                 # [B]
    attn: tuple                            # (masked, raw) [B, H, T, P]
    attn_logprob: torch.Tensor             # [B, H, T, P]
    postnet_output: Optional[torch.Tensor]  # [B, T, M] (aux, shallow), keeps its gradient


def _detach_if(x, cond):
    return x.detach() if cond and x is not None else x


class MixGANTTS(nn.Module):
    def __init__(self, mode, betas, stats, hidden=256, encoder_layers=4,
                 encoder_heads=2, conv_kernel_size=9, encoder_window_size=4,
                 decoder_layers=6, decoder_heads=2, conv_filter_size=1024,
                 max_seq_len=1000, n_mels=80, n_bins=256,
                 pitch_quantization="linear", energy_quantization="linear",
                 vp_filter_size=256, vp_kernel_size=3, residual_channels=256,
                 residual_layers=20, multi_speaker=False, n_speakers=1,
                 embedder_type="none", external_speaker_dim=512, encoder_dropout=0.2,
                 decoder_dropout=0.2, vp_dropout=0.5, device=None):
        super().__init__()
        if mode not in ("naive", "aux", "shallow"):
            raise ValueError(f"unknown mode {mode!r}")
        device = resolve_device(device)
        self.mode = mode
        self.multi_speaker = multi_speaker
        self.embedder_type = embedder_type
        self.max_seq_len = max_seq_len
        self.n_mels = n_mels
        self.linguistic_encoder = LinguisticEncoder(
            hidden=hidden, n_layers=encoder_layers, n_heads=encoder_heads,
            conv_kernel_size=conv_kernel_size, window_size=encoder_window_size,
            max_seq_len=max_seq_len, n_bins=n_bins,
            pitch_range=(stats.pitch_min, stats.pitch_max),
            energy_range=(stats.energy_min, stats.energy_max),
            pitch_quantization=pitch_quantization,
            energy_quantization=energy_quantization,
            vp_filter_size=vp_filter_size, vp_kernel_size=vp_kernel_size,
            dropout=encoder_dropout, vp_dropout=vp_dropout)
        if mode in ("aux", "shallow"):
            self.decoder = Decoder(
                hidden=hidden, n_layers=decoder_layers, n_heads=decoder_heads,
                d_inner=conv_filter_size, kernel_size=conv_kernel_size,
                max_seq_len=max_seq_len, dropout=decoder_dropout)
            self.mel_linear = nn.Linear(hidden, n_mels)
            self.postnet = PostNet(n_mels=n_mels)
        if multi_speaker:
            self.speaker_emb = (nn.Embedding(n_speakers, hidden) if embedder_type == "none"
                                else nn.Linear(external_speaker_dim, hidden))
        self.diffusion = GaussianDiffusion(
            Denoiser(n_mels=n_mels, d_encoder=hidden,
                     residual_channels=residual_channels,
                     residual_layers=residual_layers, multi_speaker=multi_speaker),
            betas, stats.spec_min[:n_mels], stats.spec_max[:n_mels])
        self.to(device)
        self.eval()

    @classmethod
    def from_configs(cls, mode, preprocess_config, model_config, stats,
                     n_speakers=1, device=None):
        """Build from the preprocess/model YAML configs, dataset stats and
        the corpus's speaker count."""
        t = model_config["transformer"]
        d = model_config["denoiser"]
        v = model_config["variance_predictor"]
        ve = model_config["variance_embedding"]
        n_mels = preprocess_config["preprocessing"]["mel"]["n_mel_channels"]
        return cls(
            mode=mode,
            betas=schedule_betas(d, mode),
            stats=stats,
            hidden=t["encoder_hidden"],
            encoder_layers=t["encoder_layer"],
            encoder_heads=t["encoder_head"],
            conv_kernel_size=t["conv_kernel_size"],
            encoder_window_size=t["encoder_window_size"],
            decoder_layers=t["decoder_layer"],
            decoder_heads=t["decoder_head"],
            conv_filter_size=t["conv_filter_size"],
            max_seq_len=model_config["max_seq_len"],
            n_mels=n_mels,
            n_bins=ve["n_bins"],
            pitch_quantization=ve["pitch_quantization"],
            energy_quantization=ve["energy_quantization"],
            vp_filter_size=v["filter_size"],
            vp_kernel_size=v["kernel_size"],
            residual_channels=d["residual_channels"],
            residual_layers=d["residual_layers"],
            multi_speaker=model_config["multi_speaker"],
            n_speakers=n_speakers,
            embedder_type=preprocess_config["preprocessing"].get("speaker_embedder", "none"),
            external_speaker_dim=model_config.get("external_speaker_dim", 512),
            encoder_dropout=t["encoder_dropout"],
            decoder_dropout=t["decoder_dropout"],
            vp_dropout=v["dropout"],
            device=device,
        )

    def forward(self, speakers, texts, src_lens, word_boundaries, src_w_lens,
                max_mel_len, p_control=1.0, e_control=1.0, d_control=1.0,
                noise_override=None, generator=None, spker_embeds=None, mels=None,
                mel_lens=None, attn_priors=None, p_targets=None, e_targets=None,
                d_targets=None, update_stats=True, return_trace=False):
        """texts [B, P] phoneme ids, src_lens [B], word_boundaries [B, W],
        src_w_lens [B]; max_mel_len is the static frame axis.  `speakers`
        [B] indexes a multi-speaker model's table; `spker_embeds`
        [B, external_speaker_dim] feeds one with an external embedder;
        single-speaker models use neither.  e_control is unused, as in the
        reference (energy follows p_control).  Activations are in the
        parameters' type.

        Training gives the raw-scale target `mels` [B, T, M] (T =
        max_mel_len), `mel_lens`, the targets `p_targets`, `e_targets`
        [B, P] and `d_targets` [B, P] (frames per phone), and for the CTC
        helper `attn_priors` [B, P, T]; `update_stats=False` keeps the
        PostNet's running statistics where they are in training mode.

        In naive and shallow inference, `return_trace` makes `mel_pred` the
        whole reverse trajectory [S+1, B, T, M], denormalised and masked
        (the train CLI's sample panels)."""
        if max_mel_len > self.max_seq_len:
            raise ValueError(
                f"max_mel_len={max_mel_len} exceeds max_seq_len="
                f"{self.max_seq_len}; raise model.yaml max_seq_len (the "
                f"positional tables are sized by it) or add a smaller "
                f"length bucket")
        B, P = texts.shape
        shallow = self.mode == "shallow"
        enc = self.linguistic_encoder(
            texts, src_lens, word_boundaries, src_w_lens, max_mel_len,
            p_control=p_control, d_control=d_control,
            mel_mask=None if mel_lens is None else sequence_mask(mel_lens, max_mel_len),
            attn_prior=attn_priors, pitch_target=p_targets, energy_target=e_targets,
            duration_target=d_targets)
        cond, mel_mask = enc.features, enc.mel_mask
        maskf = mel_mask[..., None].to(cond.dtype)
        spk = self.speaker_embedding(speakers, spker_embeds)

        coarse_mel = None
        if self.mode in ("aux", "shallow"):
            coarse = self.mel_linear(self.decoder(cond, mel_mask))
            coarse_mel = coarse + self.postnet(coarse, update_stats=update_stats)

        diffusion = self.diffusion
        ov = noise_override or {}
        x_ts = x_t_prevs = x_t_prev_preds = t = None
        if self.mode == "aux":
            mel_pred = diffusion.diffuse_trace(coarse_mel, mel_mask, generator,
                                               noises=ov.get("trace_noises"))
        elif mels is None:
            start = ov.get("start_noise")
            if shallow:
                if start is None:
                    start = torch.randn(coarse_mel.shape, generator=generator,
                                        device=coarse_mel.device, dtype=coarse_mel.dtype)
                t_start = torch.full((B,), diffusion.num_timesteps - 1,
                                     dtype=torch.long, device=cond.device)
                start = diffusion.diffuse(coarse_mel, t_start, start) * maskf
            x0 = diffusion.sampling(cond, spk, noise=start,
                                    step_noises=ov.get("step_noises"),
                                    generator=generator, return_trace=return_trace)
            mel_pred = diffusion.denorm_spec(x0) * (maskf[None] if return_trace else maskf)
        else:
            # training: one random diffusion step per utterance
            def noise(key):
                n = ov.get(key)
                return n if n is not None else torch.randn(
                    mels.shape, generator=generator, device=mels.device, dtype=cond.dtype)

            t = ov.get("t")
            if t is None:
                t = torch.randint(0, diffusion.num_timesteps, (B,), generator=generator,
                                  device=mels.device)
            x_ts = diffusion.diffuse(mels, t, noise("x_t_noise")) * maskf
            x_t_prevs = diffusion.diffuse(mels, t - 1, noise("x_t_prev_noise")) * maskf
            x0_pred = diffusion.denoise_fn(
                x_ts, t, _detach_if(cond, shallow), _detach_if(spk, shallow), fused=False)
            x0_pred = torch.clamp(x0_pred * maskf, -1.0, 1.0)
            x_start = diffusion.norm_spec(coarse_mel.detach()) if shallow else x0_pred
            x_t_prev_preds = diffusion.q_posterior_sample(
                x_start, x_ts, t, noise("posterior_noise")) * maskf
            mel_pred = x0_pred

        return GeneratorOutput(
            mel_pred=mel_pred, mel_lens=enc.mel_len, mel_mask=mel_mask,
            coarse_mel=_detach_if(coarse_mel, shallow), pitch_pred=enc.pitch_pred,
            energy_pred=_detach_if(enc.energy_pred, shallow),
            log_dur_w_pred=enc.log_dur_w_pred, dur_w_rounded=enc.dur_w_rounded,
            x_ts=x_ts, x_t_prevs=x_t_prevs, x_t_prev_preds=x_t_prev_preds,
            diffusion_step=t, speaker_emb=_detach_if(spk, shallow),
            src_mask=sequence_mask(src_lens, P),
            src_w_mask=sequence_mask(src_w_lens, word_boundaries.shape[1]),
            src_lens=src_lens, attn=enc.attn, attn_logprob=enc.attn_logprob,
            postnet_output=coarse_mel)

    def speaker_embedding(self, speakers, spker_embeds=None):
        """[B, hidden] speaker embedding of a multi-speaker model (None for a
        single-speaker one): the table row of `speakers`, or the projection
        of `spker_embeds`."""
        if not self.multi_speaker:
            return None
        if self.embedder_type == "none":
            return self.speaker_emb(speakers)
        if spker_embeds is None:
            raise ValueError(f"speaker embedder {self.embedder_type!r}: spker_embeds "
                             f"[B, {self.speaker_emb.in_features}] is required")
        return self.speaker_emb(spker_embeds.to(self.speaker_emb.weight.dtype))
