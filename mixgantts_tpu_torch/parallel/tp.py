"""Tensor-parallel (Megatron) partitioning over the mesh's `model` axis
(`mixgantts_tpu/parallel/tp.py`).

JAX's eight rules, carried over to the port's parameter names (the
reference's `state_dict` keys) and torch layouts.  Flax kernels are
[k, in, out] or [in, out] and torch's [out, in, k] or [out, in], so JAX's
"col" (the last, output dimension) is torch's dim 0 and its "row" (the
contraction dimension) torch's dim 1:
- attention q/k/v projections column-parallel (heads are contiguous
  channel blocks), output projection row-parallel;
- the encoder FFN conv column-parallel (gathered before the residual
  LayerNorm);
- the aux decoder's PositionwiseFeedForward w_1/w_2 as the column-then-row
  Megatron MLP;
- the denoiser residual blocks' convs row-parallel over the residual
  channels (the gated split of the 2C output makes output sharding
  non-local).
As in JAX, a leaf whose dimension the model axis does not divide (or
exceeds) stays replicated, so do the 1-d biases of row-parallel layers,
and Adam's moments take their parameter's spec: they live on the shards
(JAX gets this sharding of the optimizer state for free).  The layers read
whether they are sharded from their weights' shapes and run the
collectives of `collectives.py`.

A spec is a tuple over the tensor's dimensions naming "model" where it is
sharded, or () for a replicated tensor (JAX's `P()`).
"""

import contextlib
import re

import torch
import torch.nn as nn

from . import collectives

_COL = "col"  # shard the output dim (torch dim 0)
_ROW = "row"  # shard the contraction dim (torch dim 1)

_RULES = (
    # RelativeSelfAttention (models/blocks.py)
    (re.compile(r"attn_layers\.\d+\.(conv_q|conv_k|conv_v)\.(weight|bias)$"), _COL),
    (re.compile(r"attn_layers\.\d+\.conv_o\.weight$"), _ROW),
    # encoder FFN: a single conv C -> C (models/blocks.py::FFN)
    (re.compile(r"ffn_layers\.\d+\.conv\.(weight|bias)$"), _COL),
    # aux decoder attention (models/aux_decoder.py::MultiHeadAttention)
    (re.compile(r"(w_qs|w_ks|w_vs)\.(weight|bias)$"), _COL),
    (re.compile(r"slf_attn\.fc\.weight$"), _ROW),
    # aux decoder Megatron MLP (PositionwiseFeedForward w_1 -> w_2)
    (re.compile(r"pos_ffn\.w_1\.(weight|bias)$"), _COL),
    (re.compile(r"pos_ffn\.w_2\.weight$"), _ROW),
    # denoiser residual stack: row-parallel both convs (gated 2C output)
    (re.compile(r"residual_layers\.\d+\.(conv_layer|output_projection)\.conv\.weight$"), _ROW),
)

_OPTIMIZERS = (("opt_g_fs2", "G"), ("opt_g", "G"), ("opt_d", "D"))
_MOMENTS = ("exp_avg", "exp_avg_sq", "acc")   # the keys of Adam.state_dict()


def _spec_for(name, shape, model_size):
    if not shape or model_size <= 1:
        return ()
    for rule, kind in _RULES:
        if not rule.search(name):
            continue
        if kind == _COL:
            dim = 0
        else:  # _ROW: the contraction dim; 1-d biases of row layers replicate
            if len(shape) < 2:
                return ()
            dim = 1
        if shape[dim] % model_size != 0 or shape[dim] < model_size:
            return ()
        spec = [None] * len(shape)
        spec[dim] = "model"
        return tuple(spec)
    return ()


def partition_specs(tree, mesh):
    """{name: spec} of a module's parameters, or of a train state: "G.name"
    and "D.name" for the parameters, "opt.moment.G.name" (opt one of
    opt_g_fs2, opt_g, opt_d; moment exp_avg, exp_avg_sq, acc) for the
    optimizers' state, which takes its parameter's spec."""
    n = mesh.shape["model"]
    if isinstance(tree, nn.Module):
        return {name: _spec_for(name, tuple(p.shape), n) for name, p in tree.named_parameters()}
    if tree.specs is not None:
        return tree.specs
    specs = {}
    for tag, module in (("G", tree.model), ("D", tree.discriminator)):
        specs.update({f"{tag}.{k}": s for k, s in partition_specs(module, mesh).items()})
    for opt, tag in _OPTIMIZERS:
        for moment in _MOMENTS:
            specs.update({f"{opt}.{moment}.{k}": s for k, s in specs.items()
                          if k.startswith(f"{tag}.")})
    return specs


def _sharded(state, specs):
    """[(parameter, dim)] of every parameter `specs` shards."""
    out = []
    for tag, module in (("G", state.model), ("D", state.discriminator)):
        for name, p in module.named_parameters():
            spec = specs[f"{tag}.{name}"]
            if "model" in spec:
                out.append((p, spec.index("model")))
    return out


def _moment_lists(state, p):
    """(optimizer list, index) of every moment of parameter p."""
    out = []
    for opt_name, _ in _OPTIMIZERS:
        opt = getattr(state, opt_name)
        for i, q in enumerate(opt.params):
            if q is p:
                out += [(lst, i) for lst in (opt.mu, opt.nu, opt.acc) if lst is not None]
    return out


def _drop_caches(state):
    for m in state.model.modules():
        if hasattr(m, "_stacked"):   # the denoiser's kernel weight stacks
            m._stacked = None


@torch.no_grad()
def shard_state(mesh, state, specs=None):
    """Keep this rank's shard of every sharded parameter and of its moments
    (in place; `p.tp_dim` marks a sharded parameter for the optimizer's
    global norm), and tie the state to the mesh and the specs."""
    specs = specs if specs is not None else partition_specs(state, mesh)
    n, r = mesh.shape["model"], mesh.coords["model"]
    for p, dim in _sharded(state, specs):
        p.data = p.data.chunk(n, dim)[r].contiguous()
        p.tp_dim = dim
        for lst, i in _moment_lists(state, p):
            lst[i] = lst[i].chunk(n, dim)[r].contiguous()
    _drop_caches(state)
    state.mesh, state.specs = mesh, specs
    return state


@contextlib.contextmanager
def gather_state(state):
    """Inside the block every rank holds the full tensors of a state
    sharded over its mesh (parameters and moments, gathered over `model`),
    as a one-device state: `checkpoint.save_checkpoint` writes them and
    `checkpoint.restore_checkpoint` loads full tensors into them.  On exit
    each rank keeps its shard of what they hold then.  A state that is not
    sharded passes through."""
    mesh = state.mesh
    if state.specs is None or mesh.shape["model"] == 1:
        yield state
        return
    n, r = mesh.shape["model"], mesh.coords["model"]
    sharded = _sharded(state, state.specs)
    full = {}
    with torch.no_grad(), collectives.use(mesh):
        for p, dim in sharded:
            full[id(p)] = p.shape[dim] * n
            p.data = collectives.gather_from_model(p.data, dim)
            for lst, i in _moment_lists(state, p):
                lst[i] = collectives.gather_from_model(lst[i], dim)
    _drop_caches(state)
    try:
        yield state
    finally:
        with torch.no_grad():
            for p, dim in sharded:
                p.data = p.data.chunk(n, dim)[r].contiguous()
                for lst, i in _moment_lists(state, p):   # lists a restore may have replaced
                    if lst[i].shape[dim] == full[id(p)]:
                        lst[i] = lst[i].chunk(n, dim)[r].contiguous()
        _drop_caches(state)
