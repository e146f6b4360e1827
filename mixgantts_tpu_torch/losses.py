"""Training losses (`mixgantts_tpu/losses.py`): the LSGAN JCU pair, masked
MSE and the weighted mel L1, guided attention, the CTC forward sum over
the word-to-phoneme attention, feature matching, and the per-mode
generator loss.  Reductions are mask-aware sums over means, as the JAX
package takes them; the CTC forward sum is the JAX package's recursion, a
loop over frames vectorised over batch and states (not `F.ctc_loss`).

Under data parallelism each mask-weighted mean (`masked_mean`, so
`masked_mse` and `guided_attention_loss`, and `weighted_mel_l1`) is a mean
over the global batch: its numerator and denominator are summed over the
data ranks.  The plain means over equal shards need only the averaging of
the gradients over the data ranks (`collectives.average_gradients`)."""

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .parallel.collectives import data_size, data_sum

NEG_INF = -1e9


# --- adversarial (LSGAN, JCU) -------------------------------------------------

def _jcu_loss(logit_cond, logit_uncond, target):
    cond = torch.mean(torch.square(logit_cond - target))
    uncond = torch.mean(torch.square(logit_uncond - target))
    return 0.5 * (cond + uncond)


def d_loss_fn(r_logit_cond, r_logit_uncond, f_logit_cond, f_logit_uncond):
    return (_jcu_loss(r_logit_cond, r_logit_uncond, 1.0),
            _jcu_loss(f_logit_cond, f_logit_uncond, 0.0))


def g_loss_fn(f_logit_cond, f_logit_uncond):
    return _jcu_loss(f_logit_cond, f_logit_uncond, 1.0)


def get_adversarial_losses_fn(mode):
    """The (D, G) adversarial loss pair of `train.yaml loss.adv_loss_mode`."""
    if mode == "lsgan":
        return d_loss_fn, g_loss_fn
    raise NotImplementedError(
        f"loss.adv_loss_mode={mode!r}: only 'lsgan' is implemented "
        f"(matches the reference)")


# --- reconstruction helpers -----------------------------------------------------

def _global_ratio(num, den):
    """num / max(den, 1) with both sums taken over the global batch under
    data parallelism (`parallel.collectives.data_sum`)."""
    if data_size() > 1:
        num, den = data_sum(torch.stack([num, den.to(num.dtype)]))
    return num / torch.clamp(den, min=1.0)


def masked_mean(x, mask):
    m = mask.to(x.dtype)
    return _global_ratio(torch.sum(x * m), torch.sum(m))


def masked_mse(pred, target, mask):
    return masked_mean(torch.square(pred - target), mask)


def weighted_mel_l1(pred, target, mel_mask):
    """L1 weighted by the target's nonzero frames, padded frames zeroed
    first."""
    maskf = mel_mask[..., None].to(pred.dtype)
    pred = pred * maskf
    target = target * maskf
    nonzero = torch.sum(torch.abs(target), dim=-1, keepdim=True) != 0
    w = nonzero.expand(target.shape).to(pred.dtype)
    return _global_ratio(torch.sum(torch.abs(pred - target) * w), torch.sum(w))


# --- guided attention --------------------------------------------------------------

def guided_attention_loss(attn, src_lens, mel_lens, sigma=0.4, alpha=1.0):
    """Diagonal-prior penalty on one head's attention attn [B, T_mel, P]:
    1 - exp(-(x/ilen - y/olen)^2 / (2 sigma^2)) averaged over the valid
    [olen, ilen] region."""
    B, T, P = attn.shape
    y = torch.arange(T, dtype=torch.float32, device=attn.device)[None, :, None]
    x = torch.arange(P, dtype=torch.float32, device=attn.device)[None, None, :]
    il = src_lens.float()[:, None, None]
    ol = mel_lens.float()[:, None, None]
    w = 1.0 - torch.exp(-torch.square(x / il - y / ol) / (2.0 * sigma ** 2))
    valid = (y < ol) & (x < il)
    return alpha * masked_mean(attn * w, valid)


# --- CTC forward sum -------------------------------------------------------------------

def forward_sum_loss(attn_logprob, key_lens, query_lens, blank_logprob=-1.0):
    """CTC forward sum over one head's attention logits attn_logprob
    [B, T_mel, P]: every phoneme 1..key_len is visited once, in order;
    class 0 is the blank, with the constant logit `blank_logprob`.  The
    alpha recursion runs over frames, vectorised over batch and states;
    per-item lengths are masks.  Mean over the batch of the NLL divided by
    key_len, as torch's CTCLoss(reduction='mean')."""
    B, T, P = attn_logprob.shape
    dev = attn_logprob.device
    key_valid = torch.arange(P, device=dev)[None, :] < key_lens[:, None]
    logits = torch.cat([torch.full((B, T, 1), blank_logprob, dtype=attn_logprob.dtype,
                                   device=dev), attn_logprob], dim=-1)
    valid = torch.cat([torch.ones((B, 1), dtype=torch.bool, device=dev), key_valid], dim=1)
    logp = torch.log_softmax(torch.where(valid[:, None, :], logits, NEG_INF), dim=-1)

    # CTC states s = 0..2P: even -> blank, odd -> phoneme (s + 1) // 2; all
    # labels are distinct, so every odd state past 1 may skip a blank
    S = 2 * P + 1
    s = torch.arange(S, device=dev)
    state_label = torch.where(s % 2 == 1, (s + 1) // 2, 0)
    can_skip = (s % 2 == 1) & (s >= 2)
    emit = logp[:, :, state_label]                                  # [B, T, S]

    alpha = torch.cat([logp[:, 0, :2], torch.full((B, S - 2), NEG_INF, device=dev)], dim=1)
    alphas = [alpha]
    for t in range(1, T):
        advance = F.pad(alpha[:, :-1], (1, 0), value=NEG_INF)
        skip = torch.where(can_skip, F.pad(alpha[:, :-2], (2, 0), value=NEG_INF), NEG_INF)
        alpha = torch.logaddexp(torch.logaddexp(alpha, advance), skip) + emit[:, t]
        alphas.append(alpha)
    alphas = torch.stack(alphas)                                    # [T, B, S]

    # terminal: frame query_len - 1, states 2 key_len and 2 key_len - 1
    t_last = torch.clamp(query_lens - 1, 0, T - 1)
    alpha_last = alphas[t_last, torch.arange(B, device=dev)]      # [B, S]
    sl = (2 * key_lens)[:, None]
    final = torch.logaddexp(alpha_last.gather(1, sl)[:, 0], alpha_last.gather(1, sl - 1)[:, 0])
    return -torch.mean(final / key_lens.to(final.dtype))


# --- feature matching --------------------------------------------------------------------

def feature_matching_loss(D_real_cond, D_real_uncond, D_fake_cond, D_fake_uncond, n_layers):
    """L1 between real (detached) and fake features of every layer but the
    logits, both branches."""
    feat_w = 4.0 / (n_layers + 1)
    loss = 0.0
    for j in range(len(D_fake_cond) - 1):
        loss = loss + feat_w * 0.5 * (
            torch.mean(torch.abs(D_real_cond[j].detach() - D_fake_cond[j]))
            + torch.mean(torch.abs(D_real_uncond[j].detach() - D_fake_uncond[j])))
    return loss


# --- the generator loss ---------------------------------------------------------------------

class LossConfig(NamedTuple):
    mode: str
    lambda_d: float = 0.1
    lambda_p: float = 0.1
    lambda_e: float = 0.1
    lambda_fm: float = 10.0
    helper_type: str = "dga"        # 'dga' | 'ctc' | 'none'
    guided_sigma: float = 0.4
    guided_lambda: float = 1.0
    guided_weight: float = 1.0
    ctc_step: int = 0
    ctc_weight_start: float = 1.0
    ctc_weight_end: float = 1.0
    n_disc_layers: int = 5          # n_layer + n_cond_layer
    adv_loss_mode: str = "lsgan"

    @classmethod
    def from_configs(cls, mode, model_config, train_config):
        """From train.yaml's `loss` and `aligner` and model.yaml's
        `discriminator`.  Raises on a loss-selection value other than the
        one the reference ships and implements (`noise_loss`, `dur_loss`,
        `pitch_loss` are never branched on there) and on an unknown helper."""
        lc = train_config["loss"]
        al = train_config["aligner"]
        dc = model_config["discriminator"]
        get_adversarial_losses_fn(lc.get("adv_loss_mode", "lsgan"))
        for key, implemented in (("noise_loss", "l1"), ("dur_loss", "mse"),
                                 ("pitch_loss", "l1")):
            val = lc.get(key, implemented)
            if val != implemented:
                raise NotImplementedError(
                    f"train.yaml loss.{key}={val!r}: only {implemented!r} "
                    f"is implemented (the reference ships this value and "
                    f"never branches on it)")
        if al["helper_type"] not in ("dga", "ctc", "none"):
            raise NotImplementedError(
                f"aligner.helper_type={al['helper_type']!r}: "
                f"expected 'dga', 'ctc' or 'none'")
        return cls(
            mode=mode, lambda_d=lc["lambda_d"], lambda_p=lc["lambda_p"],
            lambda_e=lc["lambda_e"],
            lambda_fm=lc["lambda_fm" if mode != "shallow" else "lambda_fm_shallow"],
            helper_type=al["helper_type"], guided_sigma=al["guided_sigma"],
            guided_lambda=al["guided_lambda"], guided_weight=al["guided_weight"],
            ctc_step=al.get("ctc_step", 0),
            ctc_weight_start=al.get("ctc_weight_start", 1.0),
            ctc_weight_end=al.get("ctc_weight_end", 1.0),
            n_disc_layers=dc["n_layer"] + dc["n_cond_layer"],
            adv_loss_mode=lc.get("adv_loss_mode", "lsgan"))


def generator_loss(cfg, diffusion, out, mel_targets, pitch_targets, energy_targets,
                   step=0, Ds=None):
    """Reconstruction loss, and feature matching when `Ds` = (real_cond,
    real_uncond, fake_cond, fake_uncond) feature lists are given.

    cfg: LossConfig; diffusion: the model's `GaussianDiffusion` (mel
    normalisation); out: a training-branch `GeneratorOutput`; mel_targets
    raw-scale [B, T, n_mels].  Returns a dict of scalars: fm, recon, mel,
    postnet, pitch, energy, duration and helper losses."""
    zero = torch.zeros((), device=mel_targets.device)
    mel_mask = out.mel_mask

    if cfg.mode == "aux":
        postnet_loss = torch.mean(torch.abs(out.postnet_output - mel_targets))
        # the trace [S+1, B, T, M] of normalised mels, each denormalised
        mel_loss = sum(weighted_mel_l1(diffusion.denorm_spec(x), mel_targets, mel_mask)
                       for x in out.mel_pred)
    elif cfg.mode == "shallow":
        postnet_loss = torch.mean(torch.abs(out.postnet_output - mel_targets))
        mel_loss = weighted_mel_l1(diffusion.denorm_spec(out.mel_pred),
                                   out.coarse_mel.detach(), mel_mask)
    else:
        postnet_loss = zero
        mel_loss = weighted_mel_l1(diffusion.denorm_spec(out.mel_pred), mel_targets, mel_mask)

    duration_loss = pitch_loss = energy_loss = helper_loss = zero
    if cfg.mode != "shallow":
        log_dur_targets = torch.log(out.dur_w_rounded.float() + 1.0)
        duration_loss = masked_mse(out.log_dur_w_pred, log_dur_targets, out.src_w_mask)
        pitch_loss = masked_mse(out.pitch_pred, pitch_targets, out.src_mask)
        energy_loss = masked_mse(out.energy_pred, energy_targets, out.src_mask)
        if cfg.helper_type == "dga":
            attn_raw = out.attn[1]          # [B, H, T, P], before the mapping mask
            attn_loss = zero
            for h in range(attn_raw.shape[1]):
                attn_loss = attn_loss + guided_attention_loss(
                    attn_raw[:, h], out.src_lens, out.mel_lens,
                    cfg.guided_sigma, cfg.guided_lambda)
            helper_loss = cfg.guided_weight * attn_loss
        elif cfg.helper_type == "ctc":
            lp = out.attn_logprob           # [B, H, T, P]
            ctc = zero
            for h in range(lp.shape[1]):
                ctc = ctc + forward_sum_loss(lp[:, h], out.src_lens, out.mel_lens)
            w = cfg.ctc_weight_start if step <= cfg.ctc_step else cfg.ctc_weight_end
            helper_loss = w * ctc

    recon_loss = (mel_loss + postnet_loss + cfg.lambda_d * duration_loss
                  + cfg.lambda_p * pitch_loss + cfg.lambda_e * energy_loss + helper_loss)
    fm_loss = zero
    if Ds is not None:
        fm_loss = cfg.lambda_fm * feature_matching_loss(*Ds, n_layers=cfg.n_disc_layers)
    return dict(fm_loss=fm_loss, recon_loss=recon_loss, mel_loss=mel_loss,
                postnet_loss=postnet_loss, pitch_loss=pitch_loss, energy_loss=energy_loss,
                duration_loss=duration_loss, helper_loss=helper_loss)
