"""The port's training forward and its gradients against the JAX package's
on the CPU, in each mode, with the same weights (the bridge, strict
loads), the same batch and the same injected t and noise.

Dropout is the identity on both sides for value parity (flax's
`Dropout.__call__` patched in the test, p = 0 on the port's modules); the
dropout sites, their rates and their inputs' shapes must agree call for
call.  Tolerances: every `GeneratorOutput` field and the new PostNet
BatchNorm statistics at rtol 1e-5 with atol 1e-6 of the field's largest
magnitude (at least 1; fp32 sums in another order through five
BatchNorm'd PostNet layers differ by ~1.3e-6 of max|x|), integer outputs
equal;
each gradient tensor to max|diff| <= 1e-3 * max|g_jax|, floored at 1e-6
of the largest gradient of the model (the K-projection biases and the
PostNet's conv biases have a zero gradient by symmetry, softmax's shift
invariance and BatchNorm's mean, so theirs is rounding noise on both
sides, ~1e-8 of the largest); and the same parameters at exactly zero
gradient on both sides (shallow mode's detach).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixgantts_tpu.losses import LossConfig as JLossConfig
from mixgantts_tpu.losses import generator_loss as j_generator_loss
from mixgantts_tpu.losses import get_adversarial_losses_fn as j_adv
from mixgantts_tpu_torch.convert import discriminator_state_dict, generator_state_dict
from mixgantts_tpu_torch.losses import LossConfig, generator_loss, get_adversarial_losses_fn
from torch_port_helpers import assert_close, t
from torch_train_helpers import (
    MODEL_CONFIG, MODES, attn_priors, jax_apply_kwargs, jax_dropout_off, jax_noise,
    jax_setup, patch_jax_trace, port_dropout_off, port_setup, tiny_batch, torch_batch,
    torch_noise, train_config, training_noise,
)

def close(got, want, msg):
    scale = max(1.0, float(np.abs(np.asarray(want)).max()))
    assert_close(got, want, rtol=1e-5, atol=1e-6 * scale, msg=msg)


FIELDS = ("mel_pred", "x_ts", "x_t_prevs", "x_t_prev_preds", "speaker_emb", "diffusion_step",
          "pitch_pred", "energy_pred", "log_dur_w_pred", "dur_w_rounded", "src_mask",
          "mel_mask", "src_lens", "mel_lens", "attn_logprob", "src_w_mask",
          "postnet_output", "coarse_mel")


def jax_forward(mode, batch, noise, monkeypatch):
    """The JAX training forward (train=True, dropout off) -> (out, new
    batch_stats)."""
    model, variables, _, _ = jax_setup(mode)
    jax_dropout_off(monkeypatch)
    if mode == "aux":
        patch_jax_trace(monkeypatch, [noise["trace_noises"]])
    apply = jax.jit(lambda v, kw, ov: model.apply(
        v, **kw, max_mel_len=batch["mels"].shape[1], train=True,
        rngs={"dropout": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1)},
        noise_override=ov, mutable=["batch_stats"]))
    return apply(variables, batch, jax_noise(noise))


@pytest.mark.parametrize("mode,prior", [("aux", False), ("naive", False),
                                        ("shallow", False), ("naive", True)])
def test_training_forward_matches_jax(mode, prior, monkeypatch):
    """Every GeneratorOutput field, and the PostNet statistics the forward
    leaves; with `prior`, the CTC helper's attention prior."""
    batch = tiny_batch()
    if prior:
        batch["attn_priors"] = attn_priors(batch)
    noise = training_noise(mode, batch, seed=11)
    want, mut = jax_forward(mode, batch, noise, monkeypatch)

    port, _ = port_setup(mode)
    port_dropout_off(port)
    port.train()
    with torch.no_grad():
        got = port(**torch_batch(jax_apply_kwargs(batch)), noise_override=torch_noise(noise))

    for name in FIELDS:
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None), name
        if g is None:
            continue
        if g.dtype in (torch.bool, torch.long):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
        else:
            close(g, w, name)
    for g, w in zip(got.attn, want.attn):
        close(g, w, "attn")
    if mode != "naive":
        sd = generator_state_dict(jax_setup(mode)[1]["params"], mut["batch_stats"])
        for key, value in port.state_dict().items():
            if key.startswith("postnet") and "running" in key:
                close(value, sd[key].numpy(), key)


@pytest.mark.parametrize("mode", MODES)
def test_dropout_sites_match_jax(mode, monkeypatch):
    """Each dropout call's (rate, input shape), in order, equal on both
    sides: the encoder's attention probabilities, attention and FFN
    outputs and variance predictors; the decoder's attention and FFN; the
    PostNet's five 0.5 sites."""
    batch = tiny_batch()
    model, variables, _, _ = jax_setup(mode)
    want = []
    jax_dropout_off(monkeypatch, calls=want)
    if mode == "aux":
        patch_jax_trace(monkeypatch, [training_noise(mode, batch, 0)["trace_noises"]])
    # tracing alone makes the calls: no compile, no run
    jax.eval_shape(lambda v, kw: model.apply(
        v, **kw, max_mel_len=batch["mels"].shape[1], train=True,
        rngs={"dropout": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1)},
        mutable=["batch_stats"]), variables, batch)
    got = []
    port, _ = port_setup(mode)
    port_dropout_off(port, calls=got)
    port.train()
    with torch.no_grad():
        port(**torch_batch(jax_apply_kwargs(batch)))
    assert want and got == want


def test_port_dropout_is_dropout():
    """The port's dropout itself: active in training mode at the module's
    rate, kept values scaled by 1 / (1 - p), the identity in eval mode."""
    port, _ = port_setup("shallow")
    drop = port.postnet.drop
    assert drop.p == 0.5
    x = torch.ones(200_000)
    torch.manual_seed(0)
    port.train()
    y = drop(x)
    kept = (y != 0).float().mean().item()
    assert abs(kept - 0.5) < 0.01
    assert torch.all((y == 0) | (y == 2.0))
    port.eval()
    assert torch.equal(drop(x), x)
    rates = {m.p for m in port.modules() if isinstance(m, torch.nn.Dropout)}
    assert rates == {0.2, 0.5}


def jax_losses(mode, batch, noise, monkeypatch, helper="dga", multi_speaker=False):
    """(G loss as a function of the generator params, D loss as one of D's
    on a forward's detached pairs), composed from the JAX package's own
    functions."""
    model, variables, disc, d_params = jax_setup(mode, multi_speaker)
    jax_dropout_off(monkeypatch)
    cfg = JLossConfig.from_configs(mode, MODEL_CONFIG, train_config(helper))
    d_fn, g_fn = j_adv("lsgan")
    kw = jax_apply_kwargs(batch)
    if mode == "aux":
        patch_jax_trace(monkeypatch, [noise["trace_noises"]] * 2)

    def forward(g_params):
        out, _ = model.apply({"params": g_params, "batch_stats": variables["batch_stats"]}
                             if "batch_stats" in variables else {"params": g_params},
                             **kw, train=True, noise_override=jax_noise(noise),
                             rngs={"dropout": jax.random.PRNGKey(0),
                                   "diffusion": jax.random.PRNGKey(1)},
                             mutable=["batch_stats"])
        return out

    def feats(dp, out):
        fake = disc.apply({"params": dp}, out.x_ts, out.x_t_prev_preds, out.speaker_emb,
                          out.diffusion_step)
        real = disc.apply({"params": dp}, out.x_ts, out.x_t_prevs, out.speaker_emb,
                          out.diffusion_step)
        return real, fake

    def g_loss(g_params):
        out = forward(g_params)
        if mode == "aux":
            return j_generator_loss(cfg, model.schedule, out, batch["mels"], batch["p_targets"],
                                    batch["e_targets"])["recon_loss"]
        (real_c, real_u), (fake_c, fake_u) = feats(d_params, out)
        losses = j_generator_loss(cfg, model.schedule, out, batch["mels"], batch["p_targets"],
                                  batch["e_targets"], Ds=(real_c, real_u, fake_c, fake_u))
        return g_fn(fake_c[-1], fake_u[-1]) + losses["recon_loss"] + losses["fm_loss"]

    def d_loss(dp):
        out = jax.lax.stop_gradient(forward(variables["params"]))
        (real_c, real_u), (fake_c, fake_u) = feats(dp, out)
        r, f = d_fn(real_c[-1], real_u[-1], fake_c[-1], fake_u[-1])
        return r + f

    return g_loss, d_loss


def port_losses(mode, port, port_d, batch, noise, helper="dga"):
    """The same two losses on the port, computed in training mode."""
    cfg = LossConfig.from_configs(mode, MODEL_CONFIG, train_config(helper))
    d_fn, g_fn = get_adversarial_losses_fn("lsgan")
    port.train()
    out = port(**torch_batch(jax_apply_kwargs(batch)), noise_override=torch_noise(noise),
               update_stats=False)
    mels = t(batch["mels"])
    if mode == "aux":
        return generator_loss(cfg, port.diffusion, out, mels, t(batch["p_targets"]),
                              t(batch["e_targets"]))["recon_loss"], None
    real = port_d(out.x_ts, out.x_t_prevs, out.speaker_emb, out.diffusion_step)
    fake = port_d(out.x_ts, out.x_t_prev_preds, out.speaker_emb, out.diffusion_step)
    losses = generator_loss(cfg, port.diffusion, out, mels, t(batch["p_targets"]),
                            t(batch["e_targets"]), Ds=(*real, *fake))
    g = g_fn(fake[0][-1], fake[1][-1]) + losses["recon_loss"] + losses["fm_loss"]
    spk = None if out.speaker_emb is None else out.speaker_emb.detach()
    d_real = port_d(out.x_ts.detach(), out.x_t_prevs.detach(), spk, out.diffusion_step)
    d_fake = port_d(out.x_ts.detach(), out.x_t_prev_preds.detach(), spk, out.diffusion_step)
    r, f = d_fn(d_real[0][-1], d_real[1][-1], d_fake[0][-1], d_fake[1][-1])
    return g, r + f


def check_grads(module, want_sd, label):
    """Each parameter's gradient against the bridged JAX gradient, and the
    same parameters at exactly zero gradient."""
    zero_got, zero_want, worst = set(), set(), 0.0
    top = max(np.abs(want_sd[n].numpy()).max() for n, _ in module.named_parameters())
    for name, p in module.named_parameters():
        g = p.grad.numpy() if p.grad is not None else np.zeros(p.shape, np.float32)
        w = want_sd[name].numpy()
        scale = np.abs(w).max()
        if scale == 0:
            zero_want.add(name)
        if not g.any():
            zero_got.add(name)
        err = np.abs(g - w).max()
        assert err <= 1e-3 * max(scale, 1e-3 * top), (
            f"{label} {name}: max|diff| {err:.3g} against max|g| {scale:.3g}")
        worst = max(worst, err / max(scale, 1e-3 * top))
    assert zero_got == zero_want, (label, sorted(zero_got ^ zero_want))
    print(f"{label} gradients: worst max|diff| / bar scale {worst:.3g}")
    return zero_want


@pytest.mark.parametrize("mode,helper,multi_speaker", [
    ("aux", "dga", False), ("naive", "dga", False), ("shallow", "dga", False),
    ("naive", "ctc", False), ("naive", "dga", True), ("shallow", "dga", True)])
def test_gradients_match_jax(mode, helper, multi_speaker, monkeypatch):
    """The gradients of the step's losses (G: adv + recon + fm through a
    fixed D, or aux mode's recon; D: the JCU loss on detached pairs)
    against `jax.grad` of the same losses composed from the JAX package's
    functions.  With a speaker table, D's speaker input trains the table
    in naive mode and is detached in shallow mode."""
    batch = tiny_batch()
    if helper == "ctc":
        batch["attn_priors"] = attn_priors(batch)
    noise = training_noise(mode, batch, seed=21)
    model, variables, disc, d_params = jax_setup(mode, multi_speaker)
    g_loss, d_loss = jax_losses(mode, batch, noise, monkeypatch, helper, multi_speaker)
    g_val, g_grads = jax.jit(jax.value_and_grad(g_loss))(variables["params"])

    port, port_d = port_setup(mode, multi_speaker)
    port_dropout_off(port)
    g, d = port_losses(mode, port, port_d, batch, noise, helper)
    close(g, g_val, "G loss")
    for p in port_d.parameters():
        p.requires_grad_(False)
    g.backward()
    zero = check_grads(port, generator_state_dict(g_grads, variables.get("batch_stats", {})), "G")
    if mode == "shallow":
        # the detach freezes the variance predictors; the PostNet trains
        assert any("pitch_predictor" in n for n in zero)
        assert not any(n.startswith("postnet.") for n in zero)
    if multi_speaker:
        assert ("speaker_emb.weight" in zero) == (mode == "shallow")
    if mode == "aux":
        return
    d_val, d_grads = jax.jit(jax.value_and_grad(d_loss))(d_params)
    for p in port_d.parameters():
        p.requires_grad_(True)
        p.grad = None
    d.backward()
    close(d, d_val, "D loss")
    check_grads(port_d, {k: torch.from_numpy(np.asarray(v)) for k, v in
                         discriminator_state_dict(d_grads).items()}, "D")
