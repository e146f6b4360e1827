"""Device meshes and data parallelism (`mixgantts_tpu/parallel/mesh.py`).

A `Mesh` is a grid of devices with the axes ("data", "model"), as the JAX
package's.  Two kinds:
- training is multi-process: one rank per entry, launched by `torchrun`
  (`init_distributed` reads its environment) or spawned with an explicit
  rendezvous.  The mesh holds this rank's device and the process group of
  each axis through it.  `shard_batch` gives a rank its rows of the
  global batch, `replicate_state` broadcasts rank 0's state, and
  `shard_train_step` runs a port step with the mesh's collectives active
  (`collectives.use`): the gradients averaged over `data`, the
  tensor-parallel layers' collectives over `model`, the metrics averaged
  over `data`, so the step computes what the one-device step computes.
  One Python thread per card: the port's step is host-bound (thousands of
  launches a step), so a single controller driving N cards would take N
  times the host time;
- serving is single-process: `make_mesh(devices)` of a device list, one
  model replica per entry (`pipeline.TTSPipeline(mesh=...)`).  An entry may
  repeat a device (`["cpu"] * 8`, `["cuda:0"] * 2`).

The topology chooses the backend: `nccl` where every rank of a host has a
card of its own, `gloo` on the CPU and where ranks share a card (gloo
stages CUDA tensors through the host).  It is never switched after a
failure.
"""

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from . import collectives

AXES = ("data", "model")
_RANK_DEVICE = None       # this process's device, set by init_distributed


class Mesh:
    """A ("data", "model") grid of devices; see the module docstring.
    `shape` and `coords` map an axis name to its size and to this rank's
    position on it (0 in a single-process mesh)."""

    axis_names = AXES

    def __init__(self, devices, groups=None, rank=None):
        self.devices = devices                        # np object array [data, model]
        self.shape = dict(zip(AXES, devices.shape))
        self.size = devices.size
        self.rank = rank
        self._groups = groups or {}
        d, m = divmod(rank or 0, self.shape["model"])
        self.coords = {"data": d, "model": m}
        self.device = devices[d, m]

    @property
    def multi_process(self):
        return self.rank is not None

    def group(self, axis):
        return self._groups[axis]

    def __repr__(self):
        kind = f"rank {self.rank}" if self.multi_process else "one process"
        return (f"Mesh(data={self.shape['data']}, model={self.shape['model']}, {kind}, "
                f"device {self.device})")


def visible_devices():
    """Every visible CUDA device.  Raises where there is none, as
    `utils.tools.resolve_device` does: a caller that means the CPU names
    it."""
    n = torch.cuda.device_count()
    if not n:
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run on the CPU")
    return [torch.device(f"cuda:{i}") for i in range(n)]


def _grid(devices, data_axis, model_axis):
    n = len(devices)
    if data_axis is None:
        data_axis = n // model_axis
    if data_axis * model_axis != n:
        raise ValueError(f"a mesh of {n} devices is not data {data_axis} x model {model_axis}")
    grid = np.empty(n, dtype=object)
    grid[:] = [torch.device(d) for d in devices]
    return grid.reshape(data_axis, model_axis)


def make_mesh(devices=None, data_axis=None, model_axis=1):
    """A ("data", "model") mesh; `model_axis` defaults to 1, so every entry
    serves data parallelism.  In an initialised process group with no
    `devices`: the ranks' mesh (rank = data * model_axis + model, as JAX's
    row-major device grid) with the process group of each axis.  Otherwise
    a single-process mesh of `devices`, by default the device
    `init_distributed` chose for a run of one rank (which makes no process
    group), else every visible card (raising where there is none)."""
    if devices is not None or not (dist.is_available() and dist.is_initialized()):
        if devices is None:
            devices = [_RANK_DEVICE] if _RANK_DEVICE is not None else visible_devices()
        return Mesh(_grid(devices, data_axis, model_axis))
    world, rank = dist.get_world_size(), dist.get_rank()
    names = [None] * world
    dist.all_gather_object(names, str(_RANK_DEVICE or torch.device("cpu")))
    grid = _grid(names, data_axis, model_axis)
    D, M = grid.shape
    groups = {}
    # every rank creates every group, in the same order
    for d in range(D):
        ranks = [d * M + m for m in range(M)]
        g = dist.new_group(ranks)
        if rank in ranks:
            groups["model"] = g
    for m in range(M):
        ranks = [d * M + m for d in range(D)]
        g = dist.new_group(ranks)
        if rank in ranks:
            groups["data"] = g
    return Mesh(grid, groups, rank)


def choose_backend(device_type, local_rank, local_world):
    """(backend, this rank's device, topology) for `device_type` "cuda" or
    "cpu": nccl where the host's ranks have a card each, else gloo."""
    if device_type == "cpu":
        return "gloo", torch.device("cpu"), "CPU"
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    if n >= local_world:
        return "nccl", torch.device(f"cuda:{local_rank}"), f"{local_world} cards, nccl"
    shared = ", ".join(f"cuda:{i}" for i in range(n))
    return ("gloo", torch.device(f"cuda:{local_rank % n}"),
            f"{n} card(s), gloo (ranks share {shared})")


def init_distributed(device=None, rank=None, world_size=None, init_method="env://",
                     timeout=600):
    """Join the process group of a multi-process run and return (rank,
    world size, this rank's device).  By default from torchrun's
    environment (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT); a spawned rank passes `rank`, `world_size`
    and an `init_method` (`file://` or `tcp://localhost:<port>`).
    `device` ("cuda", the default, or "cpu") is the device type.  With one
    rank no group is made.  Rank 0 prints the topology and backend."""
    global _RANK_DEVICE
    env = os.environ
    if world_size is None:      # torchrun's
        rank, world = int(env.get("RANK", 0)), int(env.get("WORLD_SIZE", 1))
        local_rank = int(env.get("LOCAL_RANK", rank))
        local_world = int(env.get("LOCAL_WORLD_SIZE", world))
    else:                       # spawned on one host
        world, local_rank, local_world = world_size, rank, world_size
    device_type = torch.device("cuda" if device is None else device).type
    backend, dev, topology = choose_backend(device_type, local_rank, local_world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    _RANK_DEVICE = dev
    if world > 1 and not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=timeout))
        if rank == 0:
            print(f"torch.distributed: {world} ranks, {topology}", flush=True)
    return rank, world, dev


def shard_batch(mesh, batch, stacked=False):
    """This rank's rows of a global batch (a dict of numpy arrays or
    tensors; lists too): dim 0, or dim 1 of `stacked` k-step batches
    ([k, B, ...], `chunk_train_step`).  A batch axis that `data` does not
    divide raises, as JAX's sharding does."""
    n, r = mesh.shape["data"], mesh.coords["data"]
    dim = 1 if stacked else 0

    def rows(x):
        shape = (len(x),) if isinstance(x, list) else tuple(np.shape(x))
        if len(shape) <= dim:
            return x
        if shape[dim] % n:
            raise ValueError(f"a global batch of {shape[dim]} rows does not divide over "
                             f"the data axis of {n}")
        k = shape[dim] // n
        return x[r * k:(r + 1) * k] if dim == 0 else x[:, r * k:(r + 1) * k]

    return {key: rows(v) for key, v in batch.items()}


def _state_tensors(state):
    """Every tensor of a train state that ranks must agree on: G's and D's
    parameters and buffers, and the optimizers' moments and accumulators."""
    out = []
    for module in (state.model, state.discriminator):
        out += [p.data for p in module.parameters()] + list(module.buffers())
    for opt in (state.opt_g_fs2, state.opt_g, state.opt_d):
        for lst in (opt.mu, opt.nu, opt.acc):
            out += list(lst or ())
    return out


@torch.no_grad()
def replicate_state(mesh, state):
    """Broadcast rank 0's train state (parameters, buffers, moments) to
    every rank, and tie the state to `mesh`."""
    if mesh.multi_process and mesh.size > 1:
        for t in _state_tensors(state):
            dist.broadcast(t, src=0)
    state.mesh = mesh
    return state


_BATCH_DIM1_NOISE = ("trace_noises", "step_noises")   # [S, B, ...]


def shard_train_step(step_fn, mesh, state_specs=None):
    """step_fn(state, batch, noise_overrides=None) -> metrics (a
    `make_train_step` step or a `chunk_train_step` chunk) run with the
    mesh's collectives active, on this rank's rows (`shard_batch`) of the
    global batch; injected noise is the global batch's, and the step takes
    this rank's rows of it.  The metrics come back averaged over `data`,
    the global batch's.  With `state_specs` (`tp.partition_specs`) the
    state is sharded by them at the first call (`tp.shard_state`), as
    JAX's in_shardings place it."""
    from .tp import shard_state

    def sharded(state, batch, noise_overrides=None):
        if state_specs is not None and state.specs is None:
            shard_state(mesh, state, state_specs)
        with collectives.use(mesh):
            if noise_overrides is None:
                metrics = step_fn(state, batch)
            else:
                local = [shard_batch(mesh, {k: v for k, v in n.items()
                                            if k not in _BATCH_DIM1_NOISE})
                         | shard_batch(mesh, {k: v for k, v in n.items()
                                              if k in _BATCH_DIM1_NOISE}, stacked=True)
                         for n in noise_overrides]
                metrics = step_fn(state, batch, noise_overrides=local)
            keys = list(metrics)
            values = collectives.average_over_data(torch.stack([metrics[k] for k in keys]))
        return dict(zip(keys, values))

    return sharded
