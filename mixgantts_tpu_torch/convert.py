"""Weight bridge: the JAX package's parameters -> the port's state_dicts.

The JAX package's trees (`params`, `batch_stats`) come in as nested dicts
of numpy arrays.
- `generator_state_dict`: the exact inverse of
  `mixgantts_tpu/convert.py::convert_generator`, in the original MixGAN-TTS
  torch key layout that the port's `MixGANTTS` module tree has.
  A multi-speaker tree's speaker table (`speaker_emb`) or external-
  embedding projection (`speaker_proj`) both map to the reference's one key
  `speaker_emb` (the projection has a bias), and each residual block's
  `speaker_projection` to `...residual_layers.{i}.speaker_projection.linear`.
- `hifigan_state_dict`: the inverse of
  `mixgantts_tpu/models/hifigan.py::convert_torch_generator`, with plain
  `.weight`s (weight norm already folded).
- `melgan_state_dict`: the inverse of
  `mixgantts_tpu/models/melgan.py::convert_torch_melgan`, in the
  descript/melgan-neurips key layout (`model.N.*`, weight norm folded).
All three load into the port's modules with `load_state_dict(strict=True)`.
- `load_reference_generator`: the "G" of a reference `.pth.tar` (what
  `mixgantts_tpu/export.py` writes, single- or multi-speaker) into the
  port's `MixGANTTS`.

Layout rules:
- flax conv kernel [k, in, out]          -> torch Conv1d .weight [out, in, k]
- flax transposed-conv kernel [k, out, in] -> torch ConvTranspose1d [in, out, k]
- flax dense kernel [in, out]            -> torch Linear .weight [out, in]
- LayerNorm, Embedding                   -> as they are
- `batch_stats`                          -> BatchNorm running statistics
"""

import numpy as np
import torch


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv(p, prefix, out):
    out[prefix + ".weight"] = _t(np.transpose(np.asarray(p["kernel"]), (2, 1, 0)))
    if "bias" in p:
        out[prefix + ".bias"] = _t(p["bias"])


def _linear(p, prefix, out):
    out[prefix + ".weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        out[prefix + ".bias"] = _t(p["bias"])


def _torch_ln(p, prefix, out):
    out[prefix + ".weight"] = _t(p["scale"])
    out[prefix + ".bias"] = _t(p["bias"])


def _n(p, fmt):
    n = 0
    while fmt.format(n) in p:
        n += 1
    return n


def _relative_fft(p, prefix, out):
    for i in range(_n(p, "attn_{}")):
        a = p[f"attn_{i}"]
        for name in ("conv_q", "conv_k", "conv_v", "conv_o"):
            _conv(a[name]["conv"], f"{prefix}.attn_layers.{i}.{name}", out)
        out[f"{prefix}.attn_layers.{i}.emb_rel_k"] = _t(a["emb_rel_k"])
        out[f"{prefix}.attn_layers.{i}.emb_rel_v"] = _t(a["emb_rel_v"])
        for norm, key in (("norm1", "norm_layers_1"), ("norm2", "norm_layers_2")):
            out[f"{prefix}.{key}.{i}.gamma"] = _t(p[f"{norm}_{i}"]["gamma"])
            out[f"{prefix}.{key}.{i}.beta"] = _t(p[f"{norm}_{i}"]["beta"])
        _conv(p[f"ffn_{i}"]["conv"]["conv"], f"{prefix}.ffn_layers.{i}.conv", out)


def _variance_predictor(p, prefix, out):
    _conv(p["conv_0"]["conv"], prefix + ".conv_layer.conv1d_1.conv", out)
    _torch_ln(p["ln_0"], prefix + ".conv_layer.layer_norm_1", out)
    _conv(p["conv_1"]["conv"], prefix + ".conv_layer.conv1d_2.conv", out)
    _torch_ln(p["ln_1"], prefix + ".conv_layer.layer_norm_2", out)
    _linear(p["proj"], prefix + ".linear_layer", out)


def _linguistic_encoder(p, out):
    pre = "linguistic_encoder"
    out[f"{pre}.src_emb.weight"] = _t(p["src_emb"]["embedding"])
    # the torch layout keeps the position tables as [1, len, d]
    out[f"{pre}.q_position_enc"] = _t(p["q_position_enc"])[None]
    out[f"{pre}.kv_position_enc"] = _t(p["kv_position_enc"])[None]
    _relative_fft(p["phoneme_encoder"], f"{pre}.phoneme_encoder", out)
    _relative_fft(p["word_encoder"], f"{pre}.word_encoder", out)
    for name in ("duration_predictor", "pitch_predictor", "energy_predictor"):
        _variance_predictor(p[name], f"{pre}.{name}", out)
    out[f"{pre}.pitch_embedding.weight"] = _t(p["pitch_embedding"]["embedding"])
    out[f"{pre}.energy_embedding.weight"] = _t(p["energy_embedding"]["embedding"])
    for name in ("w_qs", "w_ks", "w_vs", "fc"):
        _linear(p["w2p_attn"][name]["linear"], f"{pre}.w2p_attn.{name}.linear", out)


def _decoder(p, out):
    for i in range(_n(p, "layer_{}")):
        lp, pre = p[f"layer_{i}"], f"decoder.layer_stack.{i}"
        for name in ("w_qs", "w_ks", "w_vs", "fc"):
            _linear(lp["slf_attn"][name], f"{pre}.slf_attn.{name}", out)
        _torch_ln(lp["slf_attn"]["layer_norm"], f"{pre}.slf_attn.layer_norm", out)
        _conv(lp["pos_ffn"]["w_1"]["conv"], f"{pre}.pos_ffn.w_1", out)
        _conv(lp["pos_ffn"]["w_2"]["conv"], f"{pre}.pos_ffn.w_2", out)
        _torch_ln(lp["pos_ffn"]["layer_norm"], f"{pre}.pos_ffn.layer_norm", out)


def _postnet(p, stats, out):
    for i in range(_n(p, "conv_{}")):
        pre = f"postnet.convolutions.{i}"
        _conv(p[f"conv_{i}"]["conv"], f"{pre}.0.conv", out)
        out[f"{pre}.1.weight"] = _t(p[f"bn_{i}"]["scale"])
        out[f"{pre}.1.bias"] = _t(p[f"bn_{i}"]["bias"])
        out[f"{pre}.1.running_mean"] = _t(stats[f"bn_{i}"]["mean"])
        out[f"{pre}.1.running_var"] = _t(stats[f"bn_{i}"]["var"])
        # torch's BatchNorm counts batches; the JAX tree has no such slot
        out[f"{pre}.1.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _denoiser(p, out):
    pre = "diffusion.denoise_fn"
    _conv(p["input_projection"]["conv"], f"{pre}.input_projection.0.conv", out)
    _linear(p["mlp"]["fc1"]["linear"], f"{pre}.mlp.0.linear", out)
    _linear(p["mlp"]["fc2"]["linear"], f"{pre}.mlp.2.linear", out)
    _conv(p["skip_projection"]["conv"], f"{pre}.skip_projection.conv", out)
    _conv(p["output_projection"]["conv"], f"{pre}.output_projection.conv", out)
    for i in range(_n(p, "res_{}")):
        rp, rpre = p[f"res_{i}"], f"{pre}.residual_layers.{i}"
        if "speaker_projection" in rp:
            _linear(rp["speaker_projection"]["linear"],
                    f"{rpre}.speaker_projection.linear", out)
        _conv(rp["conv_layer"]["conv"], f"{rpre}.conv_layer.conv", out)
        _linear(rp["diffusion_projection"]["linear"],
                f"{rpre}.diffusion_projection.linear", out)
        _conv(rp["conditioner_projection"]["conv"],
              f"{rpre}.conditioner_projection.conv", out)
        _conv(rp["output_projection"]["conv"], f"{rpre}.output_projection.conv", out)


def generator_state_dict(params, batch_stats):
    """JAX MixGANTTS (params, batch_stats) -> the port's MixGANTTS
    state_dict.  The mode follows the tree: decoder, mel_linear and postnet
    exist for aux and shallow only, the speaker keys for multi-speaker
    models only."""
    out = {}
    if "speaker_emb" in params:
        out["speaker_emb.weight"] = _t(params["speaker_emb"]["embedding"])
    elif "speaker_proj" in params:
        _linear(params["speaker_proj"], "speaker_emb", out)
    _linguistic_encoder(params["linguistic_encoder"], out)
    _denoiser(params["denoiser"], out)
    if "decoder" in params:
        _decoder(params["decoder"], out)
        _linear(params["mel_linear"], "mel_linear", out)
        _postnet(params["postnet"], batch_stats["postnet"], out)
    return out


def hifigan_state_dict(params):
    """JAX HiFiGANGenerator params -> the port's HiFiGANGenerator
    state_dict (plain weights)."""
    out = {}
    _conv(params["conv_pre"], "conv_pre", out)
    _conv(params["conv_post"], "conv_post", out)
    n_stages = _n(params, "ups_{}")
    n_k = _n(params, "resblocks_0_{}")
    for i in range(n_stages):
        # flax [k, out, in] -> torch ConvTranspose1d [in, out, k]: the same
        # axis reversal as a plain conv
        _conv(params[f"ups_{i}"], f"ups.{i}", out)
        for j in range(n_k):
            block = params[f"resblocks_{i}_{j}"]
            for c in range(_n(block, "convs1_{}")):
                base = f"resblocks.{i * n_k + j}"
                _conv(block[f"convs1_{c}"], f"{base}.convs1.{c}", out)
                _conv(block[f"convs2_{c}"], f"{base}.convs2.{c}", out)
    return out


def melgan_state_dict(params):
    """JAX MelGANGenerator params -> the port's MelGANGenerator state_dict,
    the descript layout of one `nn.Sequential`: conv_in at `model.1`, per
    ratio a leaky_relu, the transposed conv and the residual blocks
    (`block.2`, `block.4`, `shortcut`), then leaky_relu, reflection pad and
    conv_out."""
    out = {}
    _conv(params["conv_in"], "model.1", out)
    idx = 2
    for i in range(_n(params, "ups_{}")):
        idx += 1                                    # leaky_relu
        _conv(params[f"ups_{i}"], f"model.{idx}", out)   # [k, out, in] -> [in, out, k]
        idx += 1
        for j in range(_n(params, f"res_{i}_{{}}")):
            block = params[f"res_{i}_{j}"]
            _conv(block["block_conv"], f"model.{idx}.block.2", out)
            _conv(block["block_out"], f"model.{idx}.block.4", out)
            _conv(block["shortcut"], f"model.{idx}.shortcut", out)
            idx += 1
    _conv(params["conv_out"], f"model.{idx + 2}", out)   # after leaky_relu, pad
    return out


# Buffers the reference's modules register, so that its state_dict carries
# them: all derive from the config, the beta schedule and the corpus
# statistics, which the port derives itself (non-persistent buffers, or on
# the fly).
REFERENCE_DERIVED_BUFFERS = frozenset(
    ["diffusion." + n for n in (
        "betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod",
        "sqrt_one_minus_alphas_cumprod", "log_one_minus_alphas_cumprod",
        "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod",
        "posterior_variance", "posterior_log_variance_clipped",
        "posterior_mean_coef1", "posterior_mean_coef2", "spec_min", "spec_max")]
    + ["linguistic_encoder.abs_position_enc", "linguistic_encoder.pitch_bins",
       "linguistic_encoder.energy_bins", "decoder.position_enc"])


def load_reference_generator(model, state_dict):
    """Load the "G" state_dict of a reference checkpoint into the port's
    MixGANTTS.  Every parameter loads with `strict=True`; of the derived
    buffers, those the port also keeps must agree with its own (rtol 1e-4:
    float32 against float64 arithmetic), so a checkpoint made with other
    statistics or another schedule raises instead of loading."""
    params = {k: v for k, v in state_dict.items() if k not in REFERENCE_DERIVED_BUFFERS}
    model.load_state_dict(params, strict=True)
    own = dict(model.named_buffers())
    for key in REFERENCE_DERIVED_BUFFERS & set(state_dict) & set(own):
        theirs = np.asarray(state_dict[key], dtype=np.float64).reshape(-1)
        mine = own[key].detach().cpu().double().numpy().reshape(-1)
        if theirs.shape != mine.shape or not np.allclose(theirs, mine, rtol=1e-4, atol=1e-5):
            raise ValueError(
                f"checkpoint buffer {key} disagrees with the model's: the "
                f"checkpoint was made with other statistics (stats.json), "
                f"config or noise schedule")
