"""The port's losses (`mixgantts_tpu_torch/losses.py`), each alone, against
`mixgantts_tpu/losses.py` on the same numpy inputs, at rtol 1e-5 (atol
1e-6): the LSGAN JCU pair, masked MSE, the weighted mel L1, guided
attention, the CTC forward sum (ragged lengths), feature matching, and
the generator loss in the three modes with each helper."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixgantts_tpu import losses as jl
from mixgantts_tpu.config import NormStats
from mixgantts_tpu.models.diffusion import DiffusionSchedule
from mixgantts_tpu.models.mixgantts import GeneratorOutput as JOutput
from mixgantts_tpu_torch import losses as tl
from mixgantts_tpu_torch.models.diffusion import GaussianDiffusion
from mixgantts_tpu_torch.models.mixgantts import GeneratorOutput
from torch_port_helpers import assert_close, t
from torch_train_helpers import MODEL_CONFIG, N_MELS, TIMESTEPS, train_config

RTOL, ATOL = 1e-5, 1e-6


def close(got, want):
    assert_close(got, want, rtol=RTOL, atol=ATOL)


def test_jcu_pair():
    r = np.random.RandomState(0)
    logits = [r.randn(2, 3, 1).astype(np.float32) for _ in range(4)]
    for got, want in zip(tl.d_loss_fn(*map(t, logits)), jl.d_loss_fn(*logits)):
        close(got, want)
    close(tl.g_loss_fn(t(logits[2]), t(logits[3])), jl.g_loss_fn(logits[2], logits[3]))
    with pytest.raises(NotImplementedError, match="lsgan"):
        tl.get_adversarial_losses_fn("hinge")


def test_masked_mse_and_weighted_mel_l1():
    """Including a target frame that is all zeros (weight 0) and padding."""
    r = np.random.RandomState(1)
    pred, target = r.randn(2, 7, 5).astype(np.float32), r.randn(2, 7, 5).astype(np.float32)
    target[0, 2] = 0.0
    mask = np.arange(7)[None] < np.array([[7], [4]])
    close(tl.masked_mse(t(pred[..., 0]), t(target[..., 0]), t(mask)),
          jl.masked_mse(pred[..., 0], target[..., 0], mask))
    close(tl.weighted_mel_l1(t(pred), t(target), t(mask)),
          jl.weighted_mel_l1(pred, target, mask))


def test_guided_attention_loss():
    r = np.random.RandomState(2)
    attn = r.uniform(0, 1, (3, 9, 6)).astype(np.float32)
    src, mel = np.array([6, 4, 1]), np.array([9, 5, 7])
    close(tl.guided_attention_loss(t(attn), t(src), t(mel), 0.3, 2.0),
          jl.guided_attention_loss(attn, src, mel, 0.3, 2.0))


@pytest.mark.parametrize("key_lens,query_lens", [([5, 5], [11, 11]), ([5, 2, 3], [11, 4, 9]),
                                                 ([1, 4], [3, 6])])
def test_forward_sum_loss(key_lens, query_lens):
    """The CTC recursion with ragged key (phoneme) and query (frame)
    lengths, and its gradient."""
    B = len(key_lens)
    lp = np.random.RandomState(B).randn(B, 11, 5).astype(np.float32)
    kl, ql = np.array(key_lens), np.array(query_lens)
    x = t(lp).requires_grad_(True)
    got = tl.forward_sum_loss(x, t(kl), t(ql))
    close(got, jl.forward_sum_loss(lp, kl, ql))
    got.backward()
    want_g = jax.grad(lambda a: jl.forward_sum_loss(a, kl, ql))(lp)
    close(x.grad, want_g)


def test_feature_matching_loss():
    """The value, and no gradient into the real features."""
    r = np.random.RandomState(3)
    feats = [[r.randn(2, 4, c).astype(np.float32) for c in (3, 5, 1)] for _ in range(4)]
    tf = [[t(f).requires_grad_(True) for f in group] for group in feats]
    got = tl.feature_matching_loss(*tf, n_layers=5)
    close(got, jl.feature_matching_loss(*feats, n_layers=5))
    got.backward()
    assert all(f.grad is None for f in tf[0] + tf[1])
    assert all(f.grad is not None for f in tf[2][:-1] + tf[3][:-1])


@pytest.mark.parametrize("key,value", [("adv_loss_mode", "hinge"), ("noise_loss", "l2"),
                                       ("dur_loss", "l1"), ("pitch_loss", "mse")])
def test_loss_config_raises_on_unsupported_keys(key, value):
    tc = train_config()
    tc["loss"][key] = value
    with pytest.raises(NotImplementedError):
        jl.LossConfig.from_configs("naive", MODEL_CONFIG, tc)
    with pytest.raises(NotImplementedError, match=key if key != "adv_loss_mode" else "lsgan"):
        tl.LossConfig.from_configs("naive", MODEL_CONFIG, tc)
    tc = train_config("attention")
    with pytest.raises(NotImplementedError, match="helper_type"):
        tl.LossConfig.from_configs("naive", MODEL_CONFIG, tc)
    assert (tl.LossConfig.from_configs("shallow", MODEL_CONFIG, train_config())._asdict()
            == jl.LossConfig.from_configs("shallow", MODEL_CONFIG, train_config())._asdict())


def random_output(mode, seed, B=2, P=6, W=3, T=12, H=2):
    """A training-branch GeneratorOutput's fields, numpy, with ragged
    lengths."""
    r = np.random.RandomState(seed)
    src_lens, mel_lens, w_lens = np.array([P, P - 2]), np.array([T, T - 4]), np.array([W, W - 1])
    attn = r.uniform(0, 1, (B, H, T, P)).astype(np.float32)
    shape = (TIMESTEPS + 1, B, T, N_MELS) if mode == "aux" else (B, T, N_MELS)
    coarse = None if mode == "naive" else r.randn(B, T, N_MELS).astype(np.float32)
    return dict(
        mel_pred=r.uniform(-1, 1, shape).astype(np.float32),
        x_ts=None, x_t_prevs=None, x_t_prev_preds=None, speaker_emb=None, diffusion_step=None,
        pitch_pred=r.randn(B, P).astype(np.float32), energy_pred=r.randn(B, P).astype(np.float32),
        log_dur_w_pred=r.randn(B, W).astype(np.float32),
        dur_w_rounded=r.randint(0, 5, (B, W)),
        src_mask=np.arange(P)[None] < src_lens[:, None],
        mel_mask=np.arange(T)[None] < mel_lens[:, None],
        src_lens=src_lens, mel_lens=mel_lens,
        attn=(attn * (r.uniform(size=attn.shape) > 0.5), attn),
        attn_logprob=r.randn(B, H, T, P).astype(np.float32),
        src_w_mask=np.arange(W)[None] < w_lens[:, None],
        postnet_output=coarse, coarse_mel=coarse)


def to_port(value):
    if value is None:
        return None
    if isinstance(value, tuple):
        return tuple(t(v) for v in value)
    return t(value)


@pytest.mark.parametrize("mode", ["aux", "naive", "shallow"])
@pytest.mark.parametrize("helper", ["dga", "ctc", "none"])
def test_generator_loss(mode, helper):
    """Every loss of `generator_loss`, feature matching included."""
    stats = NormStats.default(n_mels=N_MELS)
    schedule = DiffusionSchedule.create("vpsde", TIMESTEPS, 0.1, 40, 0.008,
                                        stats.spec_min, stats.spec_max)
    diffusion = GaussianDiffusion(torch.nn.Identity(), schedule.betas, schedule.spec_min,
                                  schedule.spec_max)
    fields = random_output(mode, seed=4)
    r = np.random.RandomState(5)
    mels = r.randn(2, 12, N_MELS).astype(np.float32)
    p_t, e_t = r.randn(2, 6).astype(np.float32), r.randn(2, 6).astype(np.float32)
    Ds = [[r.randn(2, 6, c).astype(np.float32) for c in (8, 16, 1)] for _ in range(4)]
    cfg_j = jl.LossConfig.from_configs(mode, MODEL_CONFIG, train_config(helper))
    cfg_t = tl.LossConfig.from_configs(mode, MODEL_CONFIG, train_config(helper))
    want = jl.generator_loss(cfg_j, schedule, JOutput(**fields), mels, p_t, e_t, step=1, Ds=Ds)
    out = GeneratorOutput(**{k: to_port(v) for k, v in fields.items()})
    got = tl.generator_loss(cfg_t, diffusion, out, t(mels), t(p_t), t(e_t), step=1,
                            Ds=[[t(f) for f in g] for g in Ds])
    assert set(got) == set(want)
    for k in want:
        assert_close(got[k], jnp.asarray(want[k]), rtol=RTOL, atol=ATOL, msg=k)
