"""Multi-process runs of the port's sharded train step for the CPU tests
(`tests/test_torch_parallel_*.py`).

`run_ranks` starts one Python process per rank (this module run as a
script) through the port's launcher (`parallel.launch.start_ranks`):
each joins a gloo process group through a `file://` rendezvous under the
test's temporary directory, with a 60 s group timeout, and the parent
waits with a time limit and kills every rank if one hangs or fails.  The
ranks import only torch and the port, never JAX (the test modules import
JAX, and `tests/conftest.py` sets its 8-device flags).  A rank reads its
job from a pickled payload (the port's modules, the global batch and the
injected noise, built by the test) and writes its result to `rank<r>.pt`.
"""

import argparse
import os
import sys

import torch

from mixgantts_tpu_torch.parallel.launch import start_ranks

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
GROUP_TIMEOUT = 60        # seconds, each collective
JOIN_TIMEOUT = 150        # seconds, the whole run


def run_ranks(tmp_path, target, world, payload, model_axis=1, timeout=JOIN_TIMEOUT):
    """Run `target` (a function of this module) on `world` ranks over gloo
    with `payload`; returns the ranks' results in rank order."""
    d = tmp_path / f"{target}_{world}x{model_axis}"
    d.mkdir(parents=True, exist_ok=True)
    torch.save(payload, d / "payload.pt")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, HERE]), OMP_NUM_THREADS="1",
               WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world))
    start_ranks([sys.executable, os.path.abspath(__file__), target, str(d), str(model_axis)],
                world, str(d), env=env, label=target).join(timeout)
    return [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(world)]


def full_grads(module, mesh):
    """{name: the full gradient}: the tensor-parallel shards gathered."""
    from mixgantts_tpu_torch.parallel import collectives
    out = {}
    with collectives.use(mesh):
        for name, p in module.named_parameters():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            if getattr(p, "tp_dim", None) is not None:
                g = collectives.gather_from_model(g, p.tp_dim)
            out[name] = g.detach().clone()
    return out


def freeze_optimizers(state):
    """Take the optimizers out of the step: their update is a no-op, so
    the gradients stay for the test to read."""
    for opt in (state.opt_g_fs2, state.opt_g, state.opt_d):
        opt.step = lambda lr=None: False


def step(payload, mesh):
    """One step (or a chunk of `payload["chunk"]` steps) of the port on the
    mesh; returns the metrics, the full gradients (optimizers frozen with
    `payload["frozen"]`), the full parameters and moments after the step,
    each parameter's local shape, and the global norm the G optimizer
    clips by."""
    from mixgantts_tpu_torch.checkpoint import save_checkpoint
    from mixgantts_tpu_torch.parallel import (
        gather_state, partition_specs, replicate_state, shard_batch, shard_train_step,
    )
    from mixgantts_tpu_torch.parallel.collectives import use
    from mixgantts_tpu_torch.train import chunk_train_step, create_train_state, make_train_step
    model, disc = payload["model"], payload["disc"]
    mode, tc, cfg = payload["mode"], payload["train_config"], payload["model_config"]
    state = create_train_state(model, disc, tc, cfg)
    replicate_state(mesh, state)
    specs = partition_specs(state, mesh) if mesh.shape["model"] > 1 else None
    if payload.get("frozen"):
        freeze_optimizers(state)
    step_fn = make_train_step(mode, model, disc, cfg, tc)
    if payload.get("chunk"):
        fn = shard_train_step(chunk_train_step(step_fn), mesh, state_specs=specs)
        metrics = fn(state, shard_batch(mesh, payload["batch"], stacked=True))
    else:
        fn = shard_train_step(step_fn, mesh, state_specs=specs)
        metrics = fn(state, shard_batch(mesh, payload["batch"]),
                     noise_overrides=payload.get("noises"))
    grads = {"G": full_grads(model, mesh), "D": full_grads(disc, mesh)}
    with use(mesh):
        grads_local = [p.grad if p.grad is not None else torch.zeros_like(p)
                       for p in state.opt_g.params]
        norm = float(state.opt_g._global_norm(grads_local))
    local_shapes = {name: tuple(p.shape) for name, p in model.named_parameters()}
    moment_shapes = ([tuple(m.shape) for m in state.opt_g.mu] if state.opt_g.mu else
                     [tuple(m.shape) for m in state.opt_g_fs2.mu or ()])
    if payload.get("ckpt"):
        save_checkpoint(payload["ckpt"], state, tc)
    with gather_state(state):
        params = {"G": {k: v.clone() for k, v in model.state_dict().items()},
                  "D": {k: v.clone() for k, v in disc.state_dict().items()}}
        opt = state.opt_g if mode != "aux" else state.opt_g_fs2
        moments = [m.clone() for m in opt.mu] if opt.mu else None
    return dict(metrics={k: v.clone() for k, v in metrics.items()}, grads=grads,
                params=params, moments=moments, norm=norm, local_shapes=local_shapes,
                moment_shapes=moment_shapes, mesh=(mesh.shape["data"], mesh.shape["model"]))


def restore(payload, mesh):
    """A fresh state on the mesh (sharded where the model axis is > 1)
    restored from `payload["ckpt"]` at `payload["restore_step"]`; returns
    the full parameters and G's moments, and the local shapes."""
    from mixgantts_tpu_torch.checkpoint import restore_checkpoint
    from mixgantts_tpu_torch.parallel import gather_state, replicate_state, shard_state
    from mixgantts_tpu_torch.train import create_train_state
    model, disc = payload["model"], payload["disc"]
    state = create_train_state(model, disc, payload["train_config"], payload["model_config"])
    replicate_state(mesh, state)
    if mesh.shape["model"] > 1:
        shard_state(mesh, state)
    restore_checkpoint(payload["ckpt"], state, payload["restore_step"])
    local_shapes = {name: tuple(p.shape) for name, p in model.named_parameters()}
    moment_shapes = [tuple(m.shape) for m in state.opt_g.mu]
    with gather_state(state):
        params = {"G": {k: v.clone() for k, v in model.state_dict().items()},
                  "D": {k: v.clone() for k, v in disc.state_dict().items()}}
        moments = [m.clone() for m in state.opt_g.mu]
    return dict(params=params, moments=moments, local_shapes=local_shapes,
                moment_shapes=moment_shapes, step=state.step)


def recording_panels(train_module, panels):
    """The train CLI's `synth_one_sample`, appending each sample panel's
    inference trace and predicted wav to `panels`."""
    inner = train_module.synth_one_sample

    def synth(mode, batch, out, trace, *args):
        result = inner(mode, batch, out, trace, *args)
        panels.append({"trace": None if trace is None else trace.float().cpu().numpy(),
                       "wav": result[3]})
        return result

    return synth


def train_cli(payload, mesh):
    """`cli.train.main` on the CPU in the workspace `payload["root"]` with
    `payload["args"]` (the world-size flags among them) and
    `payload["configs"]`, the panels' vocoder `payload["vocoder"]`;
    returns the train and val log.txt and the sample panels
    (`recording_panels`) of each rank."""
    import types
    from mixgantts_tpu_torch.cli import train as ttrain
    os.chdir(payload["root"])
    ttrain.get_vocoder = lambda *a, **k: payload["vocoder"]
    panels = []
    ttrain.synth_one_sample = recording_panels(ttrain, panels)
    configs = payload["configs"]
    ttrain.main(types.SimpleNamespace(**payload["args"]), configs, device="cpu")
    log = configs[2]["path"]["log_path"]
    logs = {name: open(os.path.join(log, name, "log.txt")).read() if mesh.rank == 0 else None
            for name in ("train", "val")}
    return dict(logs, panels=panels)


TARGETS = {"step": step, "restore": restore, "train_cli": train_cli}


def _rank_main(target, workdir, model_axis, rank, world, init):
    import torch.distributed as dist
    from mixgantts_tpu_torch.parallel import init_distributed, make_mesh
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank))   # as torchrun sets them
    init_distributed("cpu", rank=rank, world_size=world, init_method=init,
                     timeout=GROUP_TIMEOUT)
    try:
        mesh = make_mesh(model_axis=model_axis)
        payload = torch.load(os.path.join(workdir, "payload.pt"), weights_only=False)
        torch.manual_seed(0)
        result = TARGETS[target](payload, mesh)
        torch.save(result, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("target", choices=sorted(TARGETS))
    parser.add_argument("workdir")
    parser.add_argument("model_axis", type=int)
    parser.add_argument("--rank", type=int, required=True)
    parser.add_argument("--world", type=int, required=True)
    parser.add_argument("--init", required=True)
    a = parser.parse_args()
    _rank_main(a.target, a.workdir, a.model_axis, a.rank, a.world, a.init)
