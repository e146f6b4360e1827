"""The port's opt-in train-step variants (`mixgantts_tpu_torch/train/step.py`)
against `mixgantts_tpu.train.step.make_train_step`, on the CPU, at the tiny
sizes of `tests/torch_train_helpers.py` (dropout the identity on both
sides, injected t and noise).

- `tpu.reuse_g_forward` (naive, shallow) and `tpu.reuse_aux_forward`
  (shallow): one step against the JAX step on the same weights and
  noises, at `test_torch_train_step.py`'s bars (metrics rtol 1e-4, the
  PostNet's running statistics rtol 1e-5, every parameter within 1e-2 * lr
  on >= 99.9% of its elements and within 2 * lr on all).
- The model's `aux_only` stage against JAX's (rtol 1e-4), and `aux_reuse`
  of it against the plain forward (exact).
- `tpu.compute_dtype: bfloat16`, per mode and with each forward-reuse
  variant, against the JAX package's bf16 step on the same weights and
  noises: each loss within `BF16_LOSS_RTOL` (those through the updated D
  within `BF16_UPDATED_D_RTOL`), each gradient tensor at cosine >=
  `BF16_GRAD_COSINE`, leaving out tensors whose JAX gradient norm is below
  1e-3 of the largest (their count is printed); the port's fp32 step on
  the same inputs falls outside both bars.  D's parts and G's denoiser
  compute in the dtype the JAX step's promotion gives them; the masters,
  gradients and Adam moments stay fp32.
- A 2-step `chunk_train_step` of each variant equals 2 sequential calls
  bit for bit.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mixgantts_tpu.train import step as j_step
from mixgantts_tpu.train.step import make_train_step as j_make_train_step
from mixgantts_tpu_torch.convert import discriminator_state_dict, generator_state_dict
from mixgantts_tpu_torch.train import chunk_train_step, create_train_state, make_train_step
from test_torch_train_step import NoisyModel, check_params, jax_state
from torch_port_helpers import assert_close
from torch_train_helpers import (
    MODEL_CONFIG, MODES, jax_apply_kwargs, jax_dropout_off, jax_noise, jax_setup,
    patch_jax_trace, port_dropout_off, port_setup, tiny_batch, torch_batch, torch_noise,
    train_config, training_noise,
)

VARIANTS = [("reuse_g_forward", "naive"), ("reuse_g_forward", "shallow"),
            ("reuse_aux_forward", "shallow")]


def config_with(**tpu):
    mc = copy.deepcopy(MODEL_CONFIG)
    mc["tpu"] = tpu
    return mc


def diffusion_noises(mode, batch, n):
    """n diffusion branches' injected noise (aux mode: its trace noise)."""
    return [training_noise(mode, batch, seed=30 + i) for i in range(n)]


def jax_step(mode, mc, tc, batch, jax_noises, monkeypatch, trace_noises=()):
    """One jitted JAX step from `jax_state`; its model takes `jax_noises`
    in call order."""
    model, _, disc, _ = jax_setup(mode)
    jax_dropout_off(monkeypatch)
    if trace_noises:
        patch_jax_trace(monkeypatch, trace_noises)
    step = jax.jit(j_make_train_step(mode, NoisyModel(model, jax_noises), disc, mc, tc))
    return step(jax_state(mode, tc), batch)


def port_step(mode, mc, tc, batch, noises, setup=None):
    """One port step from `port_setup`; returns (state, metrics)."""
    port, port_d = setup or port_setup(mode)
    port_dropout_off(port)
    state = create_train_state(port, port_d, tc, MODEL_CONFIG)
    metrics = make_train_step(mode, port, port_d, mc, tc)(
        state, torch_batch(batch), noise_overrides=[torch_noise(n) for n in noises])
    return state, metrics


@pytest.mark.parametrize("flag,mode", VARIANTS)
def test_variant_step_matches_jax(flag, mode, monkeypatch):
    """One step of the variant: metrics, PostNet statistics, every
    parameter of G and D after it, against the JAX step's."""
    tc = train_config()
    mc = config_with(**{flag: True})
    batch = tiny_batch()
    if flag == "reuse_g_forward":
        noises = diffusion_noises(mode, batch, 1)
        jax_noises = [jax_noise(noises[0])]
    else:   # the aux_only forward, then the two diffusion branches
        noises = diffusion_noises(mode, batch, 2)
        jax_noises = [{}] + [jax_noise(n) for n in noises]
    j_state, j_metrics = jax_step(mode, mc, tc, batch, jax_noises, monkeypatch)
    state, metrics = port_step(mode, mc, tc, batch, noises)

    assert state.step == 1 and not state.model.training
    assert set(metrics) == set(j_metrics)
    for k, v in metrics.items():
        assert_close(v, j_metrics[k], rtol=1e-4, atol=1e-6, msg=k)
    want = generator_state_dict(jax.device_get(j_state.g_params),
                                jax.device_get(j_state.g_batch_stats))
    got = state.model.state_dict()
    for name in want:
        if "running" in name:
            assert_close(got[name], want[name], rtol=1e-5, atol=1e-6, msg=name)
    worst = max(check_params(got, want, 1e-4, "G"), check_params(
        state.discriminator.state_dict(),
        discriminator_state_dict(jax.device_get(j_state.d_params)), 2e-4, "D"))
    print(f"{flag} {mode}: 99.9th percentile of |diff| / lr {worst:.3g}")


@pytest.mark.parametrize("mode", MODES)
def test_aux_only_and_aux_reuse(mode):
    """`aux_only` gives JAX's `AuxStage` field for field; the forward on
    `aux_reuse` of it gives the plain training forward's outputs exactly."""
    model, variables, _, _ = jax_setup(mode)
    batch = tiny_batch()
    noise = training_noise(mode, batch, seed=30)
    want = jax.jit(model.apply, static_argnames=("max_mel_len", "train", "aux_only"))(
        variables, **jax_apply_kwargs(batch), train=False, aux_only=True)

    port, _ = port_setup(mode)
    kw = dict(torch_batch(batch), max_mel_len=batch["mels"].shape[1])
    with torch.no_grad():
        stage = port(**kw, aux_only=True)
        assert stage._fields == want._fields
        for name, got_v, want_v in zip(stage._fields, stage, want):
            for g, w in zip(jax.tree_util.tree_leaves(got_v), jax.tree_util.tree_leaves(want_v)):
                assert_close(g, np.asarray(w), rtol=1e-4, atol=1e-5, msg=name)
        plain = port(**kw, noise_override=torch_noise(noise))
        reused = port(**kw, noise_override=torch_noise(noise), aux_reuse=stage)
    for name, a, b in zip(plain._fields, plain, reused):
        for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
            assert torch.equal(x, y), name


# (mode, tpu flags) of the bf16 cases: each mode's plain step and the two
# forward-reuse variants
BF16_CASES = [("aux", {}), ("naive", {}), ("shallow", {}),
              ("naive", {"reuse_g_forward": True}), ("shallow", {"reuse_aux_forward": True})]
BF16_IDS = ["aux", "naive", "shallow", "reuse_g_forward-naive", "reuse_aux_forward-shallow"]
# each loss against the JAX bf16 step's.  The bars come from the readings
# at these sizes, on the CPU: the port's bf16 losses are within 7.5e-6 of
# JAX's, its fp32 losses 2.6e-4 to 2.2e-3 away.  The losses that read the
# D that phase 1 updated (`UPDATED_D_KEYS`) have a bar of their own: Adam's
# first step moves each weight by about lr * sign(gradient), so a
# near-zero entry of D's bf16 gradient whose sign the two frameworks'
# roundings flip moves that weight the other way, and fm_loss, which reads
# every layer of D, comes out up to 1.8e-3 off (G_loss and total_loss,
# which add it, 1.4e-4).
BF16_LOSS_RTOL, BF16_UPDATED_D_RTOL = 3e-5, 5e-3
UPDATED_D_KEYS = ("adv_loss", "fm_loss", "G_loss", "total_loss")
# each gradient tensor against the JAX bf16 step's: the port's bf16 step
# reads cosine >= 0.99998, its fp32 step 0.976 to 0.996
BF16_GRAD_COSINE = 0.999
# the dtype each D part computes in under bf16, as the JAX step's promotion
# gives it (bf16 trunk and unconditional branch, fp32 step MLP and
# conditional branch), and G's denoiser in fp32
BF16_ACTIVATIONS = {"D conv_block.0": torch.bfloat16, "D uncond_conv_block.0": torch.bfloat16,
                    "D mlp": torch.float32, "D cond_conv_block.0": torch.float32,
                    "G diffusion.denoise_fn.residual_layers.0.conv_layer": torch.float32}


def recording_optimizer(opt):
    """`opt`, whose state also keeps the last gradients it was given."""
    def init(params):
        return opt.init(params), jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner = opt.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(init, update)


def jax_bf16_step(mode, mc, tc, batch, jax_noises, trace_noises):
    """One jitted JAX step with recording optimizers: (metrics, gradients
    under the port's `G `/`D ` state_dict names)."""
    with pytest.MonkeyPatch.context() as mp:
        for name in ("build_gan_optimizer", "build_fs2_optimizer"):
            build = getattr(j_step, name)
            mp.setattr(j_step, name, lambda *a, build=build, **k: recording_optimizer(build(*a, **k)))
        model, _, disc, _ = jax_setup(mode)
        jax_dropout_off(mp)
        if trace_noises:
            patch_jax_trace(mp, trace_noises)
        state = jax_state(mode, tc)
        zeros = functools.partial(jax.tree_util.tree_map, jnp.zeros_like)
        state = state.replace(opt_g_fs2=(state.opt_g_fs2, zeros(state.g_params)),
                              opt_g=(state.opt_g, zeros(state.g_params)),
                              opt_d=(state.opt_d, zeros(state.d_params)))
        step = jax.jit(j_step.make_train_step(mode, NoisyModel(model, jax_noises), disc, mc, tc))
        new, metrics = jax.device_get(step(state, batch))
    g = (new.opt_g_fs2 if mode == "aux" else new.opt_g)[1]
    grads = {f"G {k}": torch.as_tensor(np.asarray(v)) for k, v in
             generator_state_dict(g, jax.device_get(state.g_batch_stats)).items()
             if "running" not in k and "num_batches" not in k}
    if mode != "aux":
        grads.update({f"D {k}": torch.as_tensor(np.asarray(v))
                      for k, v in discriminator_state_dict(new.opt_d[1]).items()})
    return {k: float(v) for k, v in metrics.items()}, grads


def activation_dtypes(model, disc):
    """Forward hooks recording the output dtype of `BF16_ACTIVATIONS`' modules."""
    seen = {}
    for prefix, module in (("G", model), ("D", disc)):
        for name, m in module.named_modules():
            key = f"{prefix} {name}"
            if key in BF16_ACTIVATIONS:
                m.register_forward_hook(
                    lambda m, args, out, key=key: seen.setdefault(key, set()).add(
                        (out[0] if isinstance(out, (tuple, list)) else out).dtype))
    return seen


@functools.lru_cache(maxsize=None)
def bf16_run(case):
    """The JAX bf16 step, the port's bf16 step (with the activation dtypes
    it computed in) and the port's fp32 step, on the same weights and
    noises: {"jax": (metrics, grads), "bf16": (state, metrics, grads, dtypes),
    "fp32": (metrics, grads)}."""
    mode, flags = BF16_CASES[case]
    tc = train_config()
    batch = tiny_batch()
    n = 1 if mode == "aux" or flags.get("reuse_g_forward") else 2
    noises = diffusion_noises(mode, batch, n)
    jax_noises = [jax_noise(x) for x in noises]
    if flags.get("reuse_aux_forward"):   # the aux_only forward takes no noise
        jax_noises = [{}] + jax_noises
    trace = [x["trace_noises"] for x in noises] if mode == "aux" else ()
    out = {"jax": jax_bf16_step(mode, config_with(compute_dtype="bfloat16", **flags), tc, batch,
                                jax_noises, trace)}
    port, port_d = port_setup(mode)
    dtypes = activation_dtypes(port, port_d)
    state, metrics = port_step(mode, config_with(compute_dtype="bfloat16", **flags), tc, batch,
                               noises, setup=(port, port_d))
    out["bf16"] = state, metrics, grads_of(state), dtypes
    state, metrics = port_step(mode, config_with(**flags), tc, batch, noises)
    out["fp32"] = metrics, grads_of(state)
    return out


def loss_differences(metrics, want):
    return {k: abs(float(v) - want[k]) / max(abs(want[k]), 1e-6) for k, v in metrics.items()}


@pytest.mark.parametrize("case", range(len(BF16_CASES)), ids=BF16_IDS)
def test_bf16_step_losses_match_jax(case):
    """compute_dtype bfloat16: each loss against the JAX package's bf16
    step on the same weights and noises, at `BF16_LOSS_RTOL` (those through
    the updated D at `BF16_UPDATED_D_RTOL`); the port's fp32 step on the
    same inputs falls outside those bars."""
    run = bf16_run(case)
    want, _ = run["jax"]
    _, metrics, _, _ = run["bf16"]
    assert set(metrics) == set(want)
    for k, v in metrics.items():
        assert v.dtype == torch.float32, k
        rtol = BF16_UPDATED_D_RTOL if k in UPDATED_D_KEYS else BF16_LOSS_RTOL
        assert_close(v, want[k], rtol=rtol, atol=1e-6, msg=k)
    got = loss_differences(metrics, want)
    fp32 = loss_differences(run["fp32"][0], want)
    assert any(fp32[k] > BF16_LOSS_RTOL for k in fp32 if k not in UPDATED_D_KEYS), fp32
    worst = lambda d, keys: max(d[k] for k in keys)
    rest = [k for k in got if k not in UPDATED_D_KEYS]
    print(f"bf16 {BF16_IDS[case]}: relative loss difference against JAX's bf16 step: "
          f"{worst(got, rest):.3g} (fm_loss {got['fm_loss']:.3g}, G_loss {got['G_loss']:.3g}); "
          f"the fp32 step's {worst(fp32, rest):.3g}")


def grads_of(state):
    out = {f"G {n}": p.grad for n, p in state.model.named_parameters() if p.grad is not None}
    out.update({f"D {n}": p.grad for n, p in state.discriminator.named_parameters()
                if p.grad is not None})
    return out


def gradient_cosines(got, want):
    """Cosine of each tensor of `got` with `want`'s (a missing tensor is
    zero), over the tensors whose `want` norm is >= 1e-3 of the largest;
    returns (cosines, the names left out)."""
    largest = max(float(w.norm()) for w in want.values())
    cosines, left_out = {}, []
    for name in sorted(set(got) | set(want)):
        w = want.get(name)
        if w is None or float(w.norm()) < 1e-3 * largest:
            left_out.append(name)
            continue
        g = got.get(name, torch.zeros_like(w))
        cosines[name] = float(torch.nn.functional.cosine_similarity(
            g.flatten().double(), w.flatten().double(), dim=0))
    return cosines, left_out


@pytest.mark.parametrize("case", range(len(BF16_CASES)), ids=BF16_IDS)
def test_bf16_gradients_follow_fp32(case):
    """compute_dtype bfloat16 against the JAX package's bf16 step on the
    same weights and noises: each gradient tensor at cosine >=
    `BF16_GRAD_COSINE` (the port's fp32 step falls below it), D's parts and
    G's denoiser compute in the dtype the JAX step's promotion gives them;
    parameters, gradients and Adam moments stay fp32."""
    run = bf16_run(case)
    _, want = run["jax"]
    state, _, got, dtypes = run["bf16"]
    assert got
    cosines, left_out = gradient_cosines(got, want)
    low = {k: c for k, c in cosines.items() if c < BF16_GRAD_COSINE}
    assert not low, low
    fp32, _ = gradient_cosines(run["fp32"][1], want)
    assert min(fp32.values()) < BF16_GRAD_COSINE
    for name, g in got.items():
        assert g.dtype == torch.float32, name
    mode = BF16_CASES[case][0]
    assert all(seen == {BF16_ACTIVATIONS[k]} for k, seen in dtypes.items()), dtypes
    assert mode == "aux" or dtypes.keys() == BF16_ACTIVATIONS.keys()
    for p in list(state.model.parameters()) + list(state.discriminator.parameters()):
        assert p.dtype == torch.float32
    opts = (state.opt_g_fs2,) if mode == "aux" else (state.opt_g, state.opt_d)
    for opt in opts:
        assert all(t.dtype == torch.float32 for t in opt.mu + opt.nu)
    for name, buf in state.model.named_buffers():
        if "running" in name:
            assert buf.dtype == torch.float32, name
    print(f"bf16 {BF16_IDS[case]}: {len(cosines)} gradient tensors against JAX's bf16 step, "
          f"worst cosine {min(cosines.values()):.6f} (the fp32 step's {min(fp32.values()):.5f}); "
          f"{len(left_out)} left out (norm < 1e-3 of the largest)")


def snapshot(state):
    out = {f"G {k}": v.clone() for k, v in state.model.state_dict().items()}
    out.update({f"D {k}": v.clone() for k, v in state.discriminator.state_dict().items()})
    for name in ("opt_g_fs2", "opt_g", "opt_d"):
        for part in ("mu", "nu"):
            for i, v in enumerate(getattr(getattr(state, name), part) or []):
                out[f"{name} {part} {i}"] = v.clone()
    return out


@pytest.mark.parametrize("flag,mode", VARIANTS[::2] + [("compute_dtype", "aux"),
                                                       ("compute_dtype", "shallow")])
def test_chunked_variant_equals_sequential(flag, mode):
    """k = 2 chunked steps of the variant equal 2 sequential calls bit for
    bit (dropout on, t and noise drawn from the state's generator)."""
    mc = config_with(**{flag: "bfloat16" if flag == "compute_dtype" else True})
    tc = train_config()
    batches = [torch_batch(tiny_batch(rng=i)) for i in range(2)]

    def fresh():
        port, port_d = port_setup(mode)
        torch.manual_seed(0)
        return create_train_state(port, port_d, tc, MODEL_CONFIG), make_train_step(
            mode, port, port_d, mc, tc)

    state, step_fn = fresh()
    seq = [step_fn(state, b) for b in batches]
    want = snapshot(state)
    state, step_fn = fresh()
    metrics = chunk_train_step(step_fn)(
        state, {k: torch.stack([b[k] for b in batches]) for k in batches[0]})
    got = snapshot(state)
    assert state.step == 2 and got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    for k, v in metrics.items():
        assert torch.equal(v, torch.stack([m[k] for m in seq])), k
