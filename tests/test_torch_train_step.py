"""The port's train and eval steps (`mixgantts_tpu_torch/train/`) against
`mixgantts_tpu.train.step.make_train_step` itself, on the CPU, one full
step per mode with the same weights, batch, injected t and noise, and
dropout the identity on both sides.

The JAX step is fed its noise by a duck-typed stand-in for the model
whose `apply` adds the next `noise_override`, aux mode's trace noise by a
patched `DiffusionSchedule.diffuse_trace`; it is jitted, which traces it
once, so the stand-in hands the noise out in call order (the D phase's
forward, then the G phase's).  Tolerances: the metrics at rtol 1e-4; the
PostNet's running statistics at rtol 1e-5; every parameter after the step
within 1e-2 * lr on >= 99.9% of each tensor's elements and within 2 * lr
on all of them (Adam's first update is ~lr * sign(g), so an element whose
gradient is within rounding of zero may flip).  The tensors whose gradient
is zero by symmetry (the attention K-projection biases: softmax is
shift-invariant; the PostNet's conv biases: BatchNorm subtracts the mean)
are rounding noise on both sides and are held to the 2 * lr bound only.
"""

import copy
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mixgantts_tpu.train import optim as joptim
from mixgantts_tpu.train.state import TrainState as JTrainState
from mixgantts_tpu.train.step import make_eval_step as j_make_eval_step
from mixgantts_tpu.train.step import make_train_step as j_make_train_step
from mixgantts_tpu_torch.convert import discriminator_state_dict, generator_state_dict
from mixgantts_tpu_torch.train import (
    check_finite_metrics, create_train_state, debug_nans, make_eval_step, make_train_step,
)
from mixgantts_tpu_torch.train import optim
from torch_port_helpers import assert_close
from torch_train_helpers import (
    MODEL_CONFIG, MODES, jax_dropout_off, jax_noise, jax_setup, patch_jax_trace,
    port_dropout_off, port_setup, tiny_batch, torch_batch, torch_noise, train_config,
    training_noise,
)

SYMMETRIC_ZERO_GRAD = re.compile(r"(conv_k|w_ks)\.bias$|^postnet\.convolutions\.\d\.0\.conv\.bias$")


class NoisyModel:
    """Stands in for the JAX MixGANTTS inside `make_train_step`: each
    `apply` takes the next injected `noise_override`."""

    def __init__(self, model, noises):
        self.model, self.schedule = model, model.schedule
        self.noises = iter(noises)

    def apply(self, *args, **kwargs):
        return self.model.apply(*args, noise_override=next(self.noises), **kwargs)


def jax_state(mode, tc):
    model, variables, disc, d_params = jax_setup(mode)
    opt = tc["optimizer"]
    opt_fs2 = joptim.build_fs2_optimizer(MODEL_CONFIG, tc)
    opt_gan = joptim.build_gan_optimizer(opt["betas"], opt["grad_clip_thresh"])
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    d_params = jax.tree_util.tree_map(jnp.asarray, d_params)
    return JTrainState(
        step=jnp.asarray(0, jnp.int32), epoch=jnp.asarray(1, jnp.int32), g_params=params,
        g_batch_stats=variables.get("batch_stats", {}), d_params=d_params,
        opt_g_fs2=opt_fs2.init(params), opt_g=opt_gan.init(params), opt_d=opt_gan.init(d_params),
        lr_g=jnp.asarray(opt["init_lr_G"], jnp.float32),
        lr_d=jnp.asarray(opt["init_lr_D"], jnp.float32), rng=jax.random.PRNGKey(0))


def noises_of(mode, batch):
    n = 1 if mode == "aux" else 2
    return [training_noise(mode, batch, seed=30 + i) for i in range(n)]


def check_params(got_sd, want_sd, lr, label):
    """The module's state after the step against JAX's, at the bars above."""
    worst = 0.0
    for name, want in want_sd.items():
        if "running" in name or "num_batches" in name:
            continue
        diff = np.abs(got_sd[name].numpy() - np.asarray(want))
        assert diff.max() <= 2 * lr, f"{label} {name}: max|diff| {diff.max():.3g}, lr {lr:.3g}"
        if not SYMMETRIC_ZERO_GRAD.search(name):
            frac = np.mean(diff > 1e-2 * lr)
            assert frac <= 1e-3, f"{label} {name}: {frac:.2%} of elements past 1e-2 * lr"
            worst = max(worst, np.quantile(diff, 0.999) / lr)
    return worst


@pytest.mark.parametrize("mode", MODES)
def test_one_step_matches_jax(mode, monkeypatch):
    """One full step: metrics, PostNet statistics, every parameter of G
    and D after it."""
    tc = train_config()
    batch = tiny_batch()
    noises = noises_of(mode, batch)
    model, variables, disc, _ = jax_setup(mode)
    jax_dropout_off(monkeypatch)
    if mode == "aux":
        patch_jax_trace(monkeypatch, [n["trace_noises"] for n in noises])
    j_step = jax.jit(j_make_train_step(mode, NoisyModel(model, [jax_noise(n) for n in noises]),
                                       disc, MODEL_CONFIG, tc))
    j_state, j_metrics = j_step(jax_state(mode, tc), batch)

    port, port_d = port_setup(mode)
    port_dropout_off(port)
    state = create_train_state(port, port_d, tc, MODEL_CONFIG)
    step_fn = make_train_step(mode, port, port_d, MODEL_CONFIG, tc)
    metrics = step_fn(state, torch_batch(batch),
                      noise_overrides=[torch_noise(n) for n in noises])

    assert state.step == 1 and not port.training
    assert set(metrics) == set(j_metrics)
    for k, v in metrics.items():
        assert_close(v, j_metrics[k], rtol=1e-4, atol=1e-6, msg=k)
    want = generator_state_dict(jax.device_get(j_state.g_params),
                                jax.device_get(j_state.g_batch_stats))
    got = port.state_dict()
    for name in want:
        if "running" in name:
            assert_close(got[name], want[name], rtol=1e-5, atol=1e-6, msg=name)
    lr_g = optim.fs2_lr_schedule(32, 10, [100], 0.3)(0) if mode == "aux" else 1e-4
    worst = check_params(got, want, lr_g, "G")
    if mode != "aux":
        worst = max(worst, check_params(
            port_d.state_dict(), discriminator_state_dict(jax.device_get(j_state.d_params)),
            2e-4, "D"))
    print(f"{mode}: 99.9th percentile of |diff| / lr {worst:.3g}")


def test_noam_schedule_and_exponential_lr():
    """The FS2 lr of updates 0-2 (warm-up, then an anneal step) and the
    per-epoch GAN lr against the JAX package's."""
    for args in ((256, 2000, [360000], 0.3), (32, 1, [1], 0.3)):
        want = joptim.fs2_lr_schedule(*args)
        got = optim.fs2_lr_schedule(*args)
        for count in range(3):
            np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6)
    lr = 1e-4
    for epoch in range(1, 4):
        np.testing.assert_allclose(optim.exponential_lr(1e-4, 0.999, epoch), lr, rtol=1e-6)
        lr *= 0.999


def optax_updates(chain, grads_seq, params):
    state = chain.init(params)
    for g in grads_seq:
        upd, state = chain.update(g, state, params)
        params = optax.apply_updates(params, upd)
    return params


@pytest.mark.parametrize("every_k", [1, 2])
def test_fs2_optimizer_matches_optax(every_k):
    """Clip (active on the first update only), Adam, a non-zero weight
    decay, the Noam schedule, and with `grad_acc_step` = 2 the mean of two
    gradients applied once: three updates against the JAX package's chain."""
    tc = train_config()
    tc["optimizer_fs2"]["weight_decay"] = 0.01
    tc["optimizer"]["grad_acc_step"] = every_k
    mc = {"transformer": {"encoder_hidden": 32}}
    r = np.random.RandomState(0)
    params = {"w": r.randn(4, 3).astype(np.float32), "b": r.randn(3).astype(np.float32)}
    grads = [{k: (r.randn(*v.shape) * (3.0 if i == 0 else 0.1)).astype(np.float32)
              for k, v in params.items()} for i in range(3 * every_k)]
    want = optax_updates(joptim.build_fs2_optimizer(mc, tc), grads, params)

    tp = {k: torch.tensor(v) for k, v in params.items()}
    opt = optim.build_fs2_optimizer(tp.values(), mc, tc)
    applied = []
    for g in grads:
        for k, p in tp.items():
            p.grad = torch.tensor(g[k])
        applied.append(opt.step())
    assert applied == ([False] * (every_k - 1) + [True]) * 3
    assert opt.count == 3
    for k in params:
        assert_close(tp[k], want[k], rtol=1e-5, atol=1e-7, msg=k)


def test_grad_accumulation_matches_mean_grad():
    """grad_acc_step = 2 on the GAN optimizer: no update mid-window, then
    the update of the mean gradient (as the JAX package's
    `test_grad_accumulation_matches_mean_grad` holds optax.MultiSteps)."""
    w = torch.ones(4)
    acc = optim.build_gan_optimizer([w], (0.5, 0.9), 10.0, grad_acc_step=2)
    w.grad = torch.full((4,), 0.5)
    assert not acc.step(1.0)
    assert torch.equal(w, torch.ones(4))
    w.grad = torch.full((4,), 1.5)
    assert acc.step(1.0)
    m = torch.ones(4)
    plain = optim.build_gan_optimizer([m], (0.5, 0.9), 10.0)
    m.grad = torch.full((4,), 1.0)
    plain.step(1.0)
    assert torch.allclose(w, m, atol=1e-7)


@pytest.mark.parametrize("mode", ["aux", "naive"])
def test_eval_step_matches_jax(mode, monkeypatch):
    """The losses without updates, in eval mode (no dropout, the PostNet's
    running statistics), with injected noise, against the JAX eval step;
    nothing moves."""
    tc = train_config()
    batch = tiny_batch()
    noise = noises_of(mode, batch)[0]
    model, _, disc, _ = jax_setup(mode)
    if mode == "aux":
        patch_jax_trace(monkeypatch, [noise["trace_noises"]])
    j_eval = j_make_eval_step(mode, NoisyModel(model, [jax_noise(noise)]), disc, MODEL_CONFIG, tc)
    want = jax.jit(j_eval)(jax_state(mode, tc), batch, jax.random.PRNGKey(7))

    port, port_d = port_setup(mode)
    state = create_train_state(port, port_d, tc, MODEL_CONFIG)
    before = copy.deepcopy(port.state_dict())
    got = make_eval_step(mode, port, port_d, MODEL_CONFIG, tc)(
        state, torch_batch(batch), noise_override=torch_noise(noise))
    assert set(got) == set(want)
    for k, v in got.items():
        assert_close(v, want[k], rtol=1e-4, atol=1e-6, msg=k)
    for k, v in port.state_dict().items():
        assert torch.equal(v, before[k]), k


@pytest.mark.parametrize("mode", MODES)
def test_training_never_runs_the_inference_kernel(mode, monkeypatch):
    """A train step and an eval step take the denoiser block by block: the
    kernel's entry point (its plain version on the CPU) is never called,
    and the stack cached for the kernel is dropped (the weights move)."""
    import mixgantts_tpu_torch.models.denoiser as den

    def refuse(*args, **kwargs):
        raise AssertionError("the training path reached fused_residual_stack")

    port, port_d = port_setup(mode)
    with torch.no_grad():
        port.diffusion.denoise_fn.stacked()
    monkeypatch.setattr(den, "fused_residual_stack", refuse)
    tc = train_config()
    state = create_train_state(port, port_d, tc, MODEL_CONFIG)
    batch = torch_batch(tiny_batch())
    metrics = make_train_step(mode, port, port_d, MODEL_CONFIG, tc)(state, batch)
    check_finite_metrics(metrics, state.step)
    make_eval_step(mode, port, port_d, MODEL_CONFIG, tc)(state, batch)
    if mode != "aux":
        assert port.diffusion.denoise_fn._stacked is None


@pytest.mark.parametrize("flag,mode", [("reuse_g_forward", "naive"),
                                       ("reuse_aux_forward", "shallow"),
                                       ("compute_dtype", "naive"), ("compute_dtype", "aux")])
def test_step_flag_checks(flag, mode):
    """The opt-in step variants build a step; the JAX package's own checks
    keep their errors and warnings: the two reuse flags together, and
    reuse_aux_forward in naive mode, raise ValueError; a reuse flag in aux
    mode is inert and warns.  The port's own check: a compute_dtype other
    than float32 or bfloat16 raises ValueError (the JAX package takes any
    floating dtype)."""
    port, port_d = port_setup(mode)
    tc = train_config()
    mc = copy.deepcopy(MODEL_CONFIG)
    mc["tpu"] = {flag: "bfloat16" if flag == "compute_dtype" else True}
    assert callable(make_train_step(mode, port, port_d, mc, tc))
    if flag == "reuse_g_forward":
        mc["tpu"]["reuse_aux_forward"] = True
        with pytest.raises(ValueError, match="mutually exclusive"):
            make_train_step(mode, port, port_d, mc, tc)
    if flag == "reuse_aux_forward":
        with pytest.raises(ValueError, match="shallow"):
            make_train_step("naive", *port_setup("naive"), mc, tc)
        aux, aux_d = port_setup("aux")
        with pytest.warns(UserWarning, match="inert"):
            make_train_step("aux", aux, aux_d, mc, tc)
    if flag == "compute_dtype":
        mc["tpu"]["compute_dtype"] = "float16"
        with pytest.raises(ValueError, match="compute_dtype"):
            make_train_step(mode, port, port_d, mc, tc)


def test_check_finite_metrics_and_debug_nans():
    """The guard names the step and the keys, for tensors as for numbers;
    `debug_nans` names the backward operation that made a NaN."""
    check_finite_metrics({"G_loss": torch.tensor(1.0), "step": np.int32(3), "D_loss": 0.25}, 10)
    with pytest.raises(FloatingPointError, match=r"step 7.*G_loss"):
        check_finite_metrics({"G_loss": torch.tensor(float("nan")), "ok": 1.0}, 7)
    with pytest.raises(FloatingPointError, match="D_loss"):
        check_finite_metrics({"D_loss": np.inf, "ok": 1.0}, 3)
    x = torch.tensor([-1.0], requires_grad=True)
    with pytest.raises(RuntimeError, match="nan"):
        with debug_nans():
            torch.sqrt(x).sum().backward()
    with debug_nans(False):
        torch.sqrt(x.detach())
