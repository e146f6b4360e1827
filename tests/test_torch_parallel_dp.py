"""The port's data-parallel train step (`mixgantts_tpu_torch.parallel`)
on the CPU: ranks of separate processes over gloo
(`torch_parallel_helpers.run_ranks`), the tiny training models of
`torch_train_helpers` with the JAX package's weights, the global batch
B=8 (the tiny batch four times, as `tests/test_parallel_dp.py` tiles it),
injected t and noise for the global batch, dropout off.

- Gradients (the optimizers out of the step, so the G phase meets the D
  the one-process step meets): dp2 and dp4, naive and aux, against the
  port's one-process gradients on the same global batch within the JAX
  package's bars (`tests/test_parallel_dp.py:69-78`): rtol 1e-5 and atol
  1e-8 + 2e-6 * max|g|, max|g| floored at 1e-3.  The PostNet conv biases,
  whose gradient is zero by symmetry (training-mode BatchNorm subtracts
  the mean), are rounding noise on both sides: their max|g| is the
  model's largest gradient.
- One real step, dp2, naive and aux, against JAX's `shard_train_step` on
  the virtual 8-device CPU mesh (`tests/conftest.py`) with the same noise,
  at `tests/test_torch_train_step.py`'s bars: the metrics at rtol 1e-4,
  every parameter within 1e-2 * lr on >= 99.9% of each tensor and 2 * lr
  on all of it.
- `shard_batch` gives a rank its rows (dim 1 of stacked k-step batches),
  and a batch that `data` does not divide raises.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from jax.sharding import NamedSharding, PartitionSpec as P
from mixgantts_tpu.parallel import make_mesh as j_make_mesh
from mixgantts_tpu.parallel import shard_batch as j_shard_batch
from mixgantts_tpu.parallel import shard_train_step as j_shard_train_step
from mixgantts_tpu.train.step import make_train_step as j_make_train_step
from mixgantts_tpu_torch.convert import discriminator_state_dict, generator_state_dict
from mixgantts_tpu_torch.parallel import make_mesh, shard_batch
from mixgantts_tpu_torch.train import create_train_state, make_train_step
from mixgantts_tpu_torch.train import optim
from test_torch_train_step import NoisyModel, check_params, jax_state
from torch_parallel_helpers import freeze_optimizers, run_ranks
from torch_port_helpers import assert_close
from torch_train_helpers import (
    MODEL_CONFIG, jax_dropout_off, jax_noise, jax_setup, patch_jax_trace, port_dropout_off,
    port_setup, tiny_batch, torch_batch, torch_noise, train_config, training_noise,
)

SYMMETRIC_ZERO_GRAD = ("postnet.convolutions.", ".0.conv.bias")


def global_batch():
    """The tiny batch four times (B=8), as the JAX test tiles it."""
    return {k: np.concatenate([v] * 4) for k, v in tiny_batch().items()}


def global_noises(mode, batch):
    return [training_noise(mode, batch, seed=30 + i) for i in range(1 if mode == "aux" else 2)]


def payload(mode, batch, noises, **kw):
    model, disc = port_setup(mode)
    port_dropout_off(model)
    return dict(model=model, disc=disc, mode=mode, train_config=train_config(),
                model_config=MODEL_CONFIG, batch=torch_batch(batch),
                noises=[torch_noise(n) for n in noises], **kw)


def one_process(job, frozen=False):
    """The port's step on one process from the job's modules; returns
    (metrics, {"G": grads, "D": grads}, state)."""
    model, disc = copy.deepcopy(job["model"]), copy.deepcopy(job["disc"])
    state = create_train_state(model, disc, job["train_config"], job["model_config"])
    if frozen:
        freeze_optimizers(state)
    step_fn = make_train_step(job["mode"], model, disc, job["model_config"], job["train_config"])
    metrics = step_fn(state, job["batch"], noise_overrides=job["noises"])
    grads = {tag: {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                   for n, p in m.named_parameters()} for tag, m in (("G", model), ("D", disc))}
    return metrics, grads, state


def check_grads(got, want, label, factor=1):
    """The bars of the module docstring, `factor` times wider."""
    top = max(float(g.abs().max()) for tree in want.values() for g in tree.values())
    for tag, tree in want.items():
        for name, g in tree.items():
            symmetric = name.startswith(SYMMETRIC_ZERO_GRAD[0]) and name.endswith(
                SYMMETRIC_ZERO_GRAD[1])
            scale = top if symmetric else max(float(g.abs().max()), 1e-3)
            np.testing.assert_allclose(
                got[tag][name].numpy(), g.numpy(), rtol=1e-5 * factor,
                atol=(1e-8 + 2e-6 * scale) * factor,
                err_msg=f"{label} {tag} {name}: data-parallel gradient off the one-process one")


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("mode", ["naive", "aux"])
def test_dp_grads_match_one_process(tmp_path, mode, world):
    batch = global_batch()
    job = payload(mode, batch, global_noises(mode, batch), frozen=True)
    metrics, grads, _ = one_process(job, frozen=True)
    ranks = run_ranks(tmp_path, "step", world, job)
    for r, res in enumerate(ranks):
        for k, v in metrics.items():
            assert_close(res["metrics"][k], v, rtol=1e-5, atol=1e-7, msg=f"rank {r} {k}")
        check_grads(res["grads"], grads, f"dp{world} rank {r}")


@pytest.mark.parametrize("mode", ["naive", "aux"])
def test_dp_step_matches_jax_sharded_step(tmp_path, monkeypatch, mode):
    batch = global_batch()
    noises = global_noises(mode, batch)
    tc = train_config()
    model, variables, disc, _ = jax_setup(mode)
    jax_dropout_off(monkeypatch)
    if mode == "aux":
        patch_jax_trace(monkeypatch, [n["trace_noises"] for n in noises])
    mesh = j_make_mesh(jax.devices()[:2], model_axis=1)
    with mesh:
        step = j_shard_train_step(j_make_train_step(
            mode, NoisyModel(model, [jax_noise(n) for n in noises]), disc, MODEL_CONFIG, tc),
            mesh)
        j_state, j_metrics = step(jax.device_put(jax_state(mode, tc), NamedSharding(mesh, P())),
                                  j_shard_batch(mesh, batch))
    (res, _) = run_ranks(tmp_path, "step", 2, payload(mode, batch, noises))
    for k, v in res["metrics"].items():
        assert_close(v, j_metrics[k], rtol=1e-4, atol=1e-6, msg=k)
    want = generator_state_dict(jax.device_get(j_state.g_params),
                                jax.device_get(j_state.g_batch_stats))
    lr_g = optim.fs2_lr_schedule(32, 10, [100], 0.3)(0) if mode == "aux" else 1e-4
    check_params(res["params"]["G"], want, lr_g, "G")
    if mode != "aux":
        check_params(res["params"]["D"],
                     discriminator_state_dict(jax.device_get(j_state.d_params)), 2e-4, "D")


def test_shard_batch_rows_and_indivisible_batch():
    mesh = make_mesh(["cpu"] * 2)
    batch = global_batch()
    rows = shard_batch(mesh, batch)
    assert all(np.array_equal(rows[k], batch[k][:4]) for k in batch)
    stacked = shard_batch(mesh, {"mels": np.zeros((3, 4, 5))}, stacked=True)
    assert stacked["mels"].shape == (3, 2, 5)
    with pytest.raises(ValueError, match="does not divide"):
        shard_batch(mesh, {k: v[:3] for k, v in batch.items()})
