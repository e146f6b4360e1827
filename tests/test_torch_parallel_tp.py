"""The port's tensor-parallel (Megatron) train step
(`mixgantts_tpu_torch.parallel.tp`) on the CPU, ranks over gloo
(`torch_parallel_helpers.run_ranks`), the tiny training models of
`torch_train_helpers` with the JAX package's weights, the global batch
B=8 (the tiny batch four times), injected t and noise, dropout off unless
said.

- The shard map: the port's `partition_specs` shards exactly the leaves
  JAX's `partition_specs` shards, along the same dimension (flax's
  [k, in, out] / [in, out] reversed in torch), at model axes 2 and 4; the
  leaves a model axis does not divide stay replicated.
- Gradients (optimizers out of the step): tp2 naive, dp2 x tp2 aux, tp4
  shallow (a shard splits an attention head) against the port's one-process
  gradients at ten times the data-parallel bars (rtol 1e-4, atol 1e-7 +
  2e-5 * max|g|, `test_torch_parallel_dp.check_grads`): the row-parallel
  layers sum the forward's products in another order too (at the
  data-parallel bars one element of 1024 sat at 1.14 of the bar); the global norm the
  clip reads under TP equals the one-process norm (rtol 1e-6) and exceeds
  the clip threshold (1), so the clip scales.
- One real step, tp2 naive and dp2 x tp2 aux, against JAX's
  `shard_train_step` with its `partition_specs` on the same mesh shape, at
  `tests/test_parallel_tp.py`'s bars: the metrics at rtol 2e-4 / atol
  2e-5, the parameters at rtol 2e-3 / atol 2 * (lr_1 + lr_2) (Adam's
  sign-flip envelope: 6e-3 aux, 3e-4 GAN); the weights and Adam moments
  sharded on each rank (row-parallel denoiser convs hold C/2 input
  channels, their moments too).
- Checkpoints: a dp2 x tp2 step's checkpoint restores in one process
  (parameters and moments equal the ranks' gathered ones exactly), and a
  one-process checkpoint restores into dp2 x tp2 ranks, which keep their
  shards.
- `chunk_train_step` on a dp2 x tp2 mesh (JAX's
  `test_chunked_step_on_dp_tp_mesh`): k=2 stacked batches, both steps'
  metrics against the one-process chunk at rtol 1e-5.
- Dropout on (p = 0.2): a dp2 x tp2 shallow step equals one process's
  with the default generator seeded alike (the masks are drawn for the
  global batch and whole heads), metrics at rtol 1e-5.
- `dryrun_multigpu(4, device="cpu")`: its three phases on a (2, 2) mesh.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from mixgantts_tpu.parallel import make_mesh as j_make_mesh
from mixgantts_tpu.parallel import partition_specs as j_partition_specs
from mixgantts_tpu.parallel import shard_batch as j_shard_batch
from mixgantts_tpu.parallel import shard_state as j_shard_state
from mixgantts_tpu.parallel import shard_train_step as j_shard_train_step
from mixgantts_tpu.train.step import make_train_step as j_make_train_step
from mixgantts_tpu_torch.checkpoint import restore_checkpoint, save_checkpoint
from mixgantts_tpu_torch.convert import generator_state_dict
from mixgantts_tpu_torch.dryrun import dryrun_multigpu
from mixgantts_tpu_torch.parallel import make_mesh, partition_specs
from mixgantts_tpu_torch.train import chunk_train_step, create_train_state, make_train_step
from mixgantts_tpu_torch.train import optim
from test_torch_parallel_dp import check_grads, global_batch, global_noises, one_process, payload
from test_torch_train_step import NoisyModel, jax_state
from torch_parallel_helpers import run_ranks
from torch_port_helpers import assert_close
from torch_train_helpers import (
    MODEL_CONFIG, jax_dropout_off, jax_noise, jax_setup, patch_jax_trace, port_setup,
    train_config,
)


def jax_leaf_map(variables):
    """{port parameter name: (JAX leaf path, JAX leaf shape)}: each JAX
    leaf filled with its own index, through the weight bridge."""
    leaves, treedef = jax.tree_util.tree_flatten_with_path(variables["params"])
    tagged = jax.tree_util.tree_unflatten(
        treedef, [np.full(np.shape(x), i + 1, np.float32) for i, (_, x) in enumerate(leaves)])
    out = {}
    for name, t in generator_state_dict(tagged, variables.get("batch_stats", {})).items():
        values = torch.unique(t)
        if len(values) == 1 and float(values[0]) >= 1:
            path, x = leaves[int(values[0]) - 1]
            out[name] = (jax.tree_util.keystr(path), np.shape(x))
    return out


@pytest.mark.parametrize("model_axis", [2, 4])
@pytest.mark.parametrize("mode", ["naive", "shallow"])
def test_shard_map_matches_jax(mode, model_axis):
    model, variables, _, _ = jax_setup(mode)
    j_specs = j_partition_specs(variables["params"], j_make_mesh(jax.devices()[:8],
                                                                model_axis=model_axis))
    j_by_path = {jax.tree_util.keystr(p): s for p, s in
                 jax.tree_util.tree_flatten_with_path(
                     j_specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))[0]}
    port, _ = port_setup(mode)
    specs = partition_specs(port, make_mesh(["cpu"] * 8, model_axis=model_axis))
    leaf_map = jax_leaf_map(variables)
    sharded = 0
    for name, p in port.named_parameters():
        path, shape = leaf_map[name]
        j_spec = tuple(j_by_path[path])
        # the sharded dimension, counted from the end in flax's layout and
        # from the start in torch's (the layouts are each other's reverse)
        want = None if "model" not in j_spec else len(shape) - 1 - j_spec.index("model")
        got = specs[name].index("model") if "model" in specs[name] else None
        assert got == want, f"{name} ({path}): port {specs[name]}, JAX {j_by_path[path]}"
        sharded += got is not None
    assert sharded > 0


def test_indivisible_dims_stay_replicated():
    port, disc = port_setup("shallow")
    state = create_train_state(port, disc, train_config(), MODEL_CONFIG)
    for axis in (3, 64):
        specs = partition_specs(state, make_mesh(["cpu"] * axis, model_axis=axis))
        for key, spec in specs.items():
            tag, name = key.split(".", 1) if key[0] in "GD" else key.split(".", 3)[2:]
            module = port if tag == "G" else disc
            shape = dict(module.named_parameters())[name].shape
            for size, s in zip(shape, spec):
                assert s is None or size % axis == 0, (key, spec, tuple(shape))
    specs = partition_specs(state, make_mesh(["cpu"] * 4, model_axis=4))
    assert specs["opt_g.exp_avg.G.diffusion.denoise_fn.residual_layers.0.conv_layer.conv.weight"] \
        == (None, "model", None)


@pytest.mark.parametrize("mode,world,model_axis", [("naive", 2, 2), ("aux", 4, 2),
                                                   ("shallow", 4, 4)])
def test_tp_grads_and_norm_match_one_process(tmp_path, mode, world, model_axis):
    batch = global_batch()
    job = payload(mode, batch, global_noises(mode, batch), frozen=True)
    metrics, grads, state = one_process(job, frozen=True)
    norm = float(torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(p.grad if p.grad is not None else torch.zeros_like(p))
         for p in state.opt_g.params])))
    assert norm > train_config()["optimizer"]["grad_clip_thresh"]
    for r, res in enumerate(run_ranks(tmp_path, "step", world, job, model_axis=model_axis)):
        for k, v in metrics.items():
            assert_close(res["metrics"][k], v, rtol=1e-5, atol=1e-7, msg=f"rank {r} {k}")
        check_grads(res["grads"], grads, f"tp{model_axis} rank {r}", factor=10)
        assert_close(res["norm"], norm, rtol=1e-6, atol=0, msg="global norm")


@pytest.mark.parametrize("mode,world", [("naive", 2), ("aux", 4)])
def test_tp_step_matches_jax_sharded_step(tmp_path, monkeypatch, mode, world):
    batch = global_batch()
    noises = global_noises(mode, batch)
    tc = train_config()
    model, variables, disc, _ = jax_setup(mode)
    jax_dropout_off(monkeypatch)
    if mode == "aux":
        patch_jax_trace(monkeypatch, [n["trace_noises"] for n in noises])
    mesh = j_make_mesh(jax.devices()[:world], model_axis=2)
    state = jax_state(mode, tc)
    specs = j_partition_specs(state, mesh)
    with mesh:
        step = j_shard_train_step(j_make_train_step(
            mode, NoisyModel(model, [jax_noise(n) for n in noises]), disc, MODEL_CONFIG, tc),
            mesh, state_specs=specs)
        j_state, j_metrics = step(j_shard_state(mesh, state, specs), j_shard_batch(mesh, batch))
    ranks = run_ranks(tmp_path, "step", world, payload(mode, batch, noises), model_axis=2)
    res = ranks[0]
    for k, v in res["metrics"].items():
        assert_close(v, j_metrics[k], rtol=2e-4, atol=2e-5, msg=k)
    want = generator_state_dict(jax.device_get(j_state.g_params),
                                jax.device_get(j_state.g_batch_stats))
    lr_tol = 2 * (6e-3 if mode == "aux" else 3e-4)
    for name, w in want.items():
        np.testing.assert_allclose(res["params"]["G"][name].numpy(), np.asarray(w),
                                   rtol=2e-3, atol=lr_tol, err_msg=name)
    # the weights and their Adam moments live on the shards
    conv = "diffusion.denoise_fn.residual_layers.0.conv_layer.conv.weight"
    full = tuple(res["params"]["G"][conv].shape)
    assert res["local_shapes"][conv] == (full[0], full[1] // 2, full[2])
    names = list(res["local_shapes"])
    assert res["moment_shapes"][names.index(conv)] == res["local_shapes"][conv]


def test_checkpoints_cross_between_dp_tp_and_one_process(tmp_path):
    batch = global_batch()
    tc = train_config()
    job = payload("naive", batch, global_noises("naive", batch),
                  ckpt=str(tmp_path / "dp_tp"))
    (res, *_) = run_ranks(tmp_path, "step", 4, job, model_axis=2)
    model, disc = copy.deepcopy(job["model"]), copy.deepcopy(job["disc"])
    state = create_train_state(model, disc, tc, MODEL_CONFIG)
    restore_checkpoint(str(tmp_path / "dp_tp"), state, 1)
    for tag, module in (("G", model), ("D", disc)):
        for k, v in module.state_dict().items():
            assert torch.equal(v, res["params"][tag][k]), f"{tag} {k}"
    for got, want in zip(state.opt_g.mu, res["moments"]):
        assert torch.equal(got, want)

    # and back: a one-process checkpoint into dp2 x tp2 ranks
    step_fn = make_train_step("naive", model, disc, MODEL_CONFIG, tc)
    step_fn(state, job["batch"], noise_overrides=job["noises"])
    save_checkpoint(str(tmp_path / "one"), state, tc)
    ranks = run_ranks(tmp_path, "restore", 4,
                      dict(job, ckpt=str(tmp_path / "one"), restore_step=2), model_axis=2)
    conv = "diffusion.denoise_fn.residual_layers.0.conv_layer.conv.weight"
    for res in ranks:
        assert res["step"] == 2
        assert res["local_shapes"][conv][1] == model.state_dict()[conv].shape[1] // 2
        for k, v in model.state_dict().items():
            assert torch.equal(v, res["params"]["G"][k]), k
        for got, want in zip(res["moments"], state.opt_g.mu):
            assert torch.equal(got, want)


def test_chunked_step_on_dp_tp_mesh(tmp_path):
    batch = global_batch()
    batch2 = dict(batch, mels=batch["mels"] + 0.1)
    stacked = {k: torch.as_tensor(np.stack([batch[k], batch2[k]])) for k in batch}
    job = dict(payload("naive", batch, []), batch=stacked, chunk=True)
    model, disc = copy.deepcopy(job["model"]), copy.deepcopy(job["disc"])
    state = create_train_state(model, disc, job["train_config"], MODEL_CONFIG)
    chunk = chunk_train_step(make_train_step("naive", model, disc, MODEL_CONFIG,
                                             job["train_config"]))
    want = chunk(state, stacked)
    for r, res in enumerate(run_ranks(tmp_path, "step", 4, job, model_axis=2)):
        assert res["metrics"]["total_loss"].shape == (2,)
        for k, v in want.items():
            assert_close(res["metrics"][k], v, rtol=1e-5, atol=1e-6, msg=f"rank {r} {k}")


def test_dropout_on_follows_one_process(tmp_path):
    batch = global_batch()
    job = payload("shallow", batch, global_noises("shallow", batch))
    for m in job["model"].modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.2
    torch.manual_seed(0)   # the ranks seed their default generator 0 too
    metrics, _, _ = one_process(job)
    (res, *_) = run_ranks(tmp_path, "step", 4, job, model_axis=2)
    for k, v in metrics.items():
        assert_close(res["metrics"][k], v, rtol=1e-5, atol=1e-6, msg=k)


def test_dryrun_multigpu_on_cpu(capfd):
    dryrun_multigpu(4, device="cpu", timeout=150)
    out = capfd.readouterr().out
    for phase in ("naive train step", "shallow train step", "dp synthesis"):
        assert f"dryrun phase [{phase}] mesh=data2xmodel2" in out
