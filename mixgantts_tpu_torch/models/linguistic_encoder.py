"""Linguistic encoder (`mixgantts_tpu/models/linguistic_encoder.py`):
phoneme encoder -> pitch/energy predictors and embeddings -> word pooling
-> word encoder -> word durations -> word-level length regulation ->
word-to-phoneme attention.

All shapes are static: the frame axis is always `max_mel_len`, with the
predicted `mel_len` and a mask.  Training teacher-forces the pitch and
energy embeddings and the durations (phone-level targets, summed per word
and rounded), and takes the mel mask of the target mels.  The
word-to-phoneme position tables are parameters that train, as in the JAX
package (the decoder's table is a constant in both).

A synthesis call on CUDA replays a CUDA graph of the encoder's body, one
per key (`LinguisticEncoder.graph_key`), so the host enqueues one graph in
place of ~1,000 small ops; every other call (training, validation with
its targets, a sharded forward, the CPU) runs the body eagerly.  A key's
first call runs eagerly, which sets cuBLAS and cuDNN up; its second
captures the graph; every call after replays it.  The graphs of one
encoder allocate from one memory pool, and a replay returns clones of the
graph's outputs, so a later replay overwrites no tensor a caller holds.
A graph reads the parameters and buffers at the addresses it was captured
on, in the types it was captured in: the graphs are dropped when any of
them moves or changes type (`.to()`, a load with `assign=True`, a
tensor-parallel gather), and in-place updates (the optimizer, a plain
`load_state_dict`) reach them.  Counters: `graph_eager` (a key's first
call), `graph_captures` and `graph_replays`; a call outside the graph's
rule counts in none.
"""

from typing import NamedTuple

import numpy as np
import torch
import torch.nn as nn

from ..ops import (
    length_regulate, mapping_mask, rel_position_coef, sequence_mask,
    word_level_pooling,
)
from ..parallel.collectives import data_size, model_size
from ..text.symbols import symbols
from ..utils.profiling import span
from .blocks import (
    RelativeFFTBlock, VariancePredictor, WordToPhonemeAttention,
    sinusoid_position_table,
)


class LinguisticEncoderOutput(NamedTuple):
    features: torch.Tensor        # [B, T_mel, H] frame-level conditioning
    pitch_pred: torch.Tensor      # [B, P]
    energy_pred: torch.Tensor     # [B, P]
    log_dur_w_pred: torch.Tensor  # [B, W]
    dur_w_rounded: torch.Tensor   # [B, W] frames per word
    mel_len: torch.Tensor         # [B]
    mel_mask: torch.Tensor        # [B, T_mel] bool, True = valid
    attn: tuple                   # (masked, raw) [B, H, T_mel, P]
    attn_logprob: torch.Tensor    # [B, H, T_mel, P]


def _bins(lo, hi, n_bins, quantization):
    if quantization == "log":
        edges = np.exp(np.linspace(np.log(lo), np.log(hi), n_bins - 1))
    else:
        edges = np.linspace(lo, hi, n_bins - 1)
    return torch.tensor(edges, dtype=torch.float32)


def _addresses(module, out):
    """The data address and type of each of `module`'s parameters and
    buffers, its submodules' included, appended to `out`."""
    for tensors in (module._parameters, module._buffers):
        out += [(t.data_ptr(), t.dtype) for t in tensors.values() if t is not None]
    for m in module._modules.values():
        _addresses(m, out)
    return out


class _Graphs:
    """An encoder's CUDA graphs: by key, None after the key's first (eager)
    call, then (graph, static inputs, static outputs); one memory pool and
    one capture stream for all of them, and the addresses and types of the
    tensors they read.  A copy of the module (`copy.deepcopy`, pickling)
    starts with none."""

    def __init__(self, addresses=None):
        self.entries, self.pool, self.stream, self.addresses = {}, None, None, addresses

    def __deepcopy__(self, memo):
        return _Graphs()

    def __reduce__(self):
        return _Graphs, ()


class LinguisticEncoder(nn.Module):
    def __init__(self, hidden=256, n_layers=4, n_heads=2, conv_kernel_size=9,
                 window_size=4, max_seq_len=1000, n_bins=256,
                 pitch_range=(-2.0, 10.0), energy_range=(-1.5, 8.0),
                 pitch_quantization="linear", energy_quantization="linear",
                 vp_filter_size=256, vp_kernel_size=3, dropout=0.2, vp_dropout=0.5):
        super().__init__()
        H = hidden
        self.src_emb = nn.Embedding(len(symbols) + 1, H)
        self.phoneme_encoder = RelativeFFTBlock(
            H, n_heads, n_layers, conv_kernel_size, window_size, dropout)
        self.word_encoder = RelativeFFTBlock(
            H, n_heads, n_layers, conv_kernel_size, window_size, dropout)
        self.duration_predictor = VariancePredictor(H, vp_filter_size, vp_kernel_size, vp_dropout)
        self.pitch_predictor = VariancePredictor(H, vp_filter_size, vp_kernel_size, vp_dropout)
        self.energy_predictor = VariancePredictor(H, vp_filter_size, vp_kernel_size, vp_dropout)
        self.pitch_embedding = nn.Embedding(n_bins, H)
        self.energy_embedding = nn.Embedding(n_bins, H)
        table = torch.from_numpy(sinusoid_position_table(max_seq_len + 1, H))[None]
        self.q_position_enc = nn.Parameter(table.clone())
        self.kv_position_enc = nn.Parameter(table.clone())
        self.w2p_attn = WordToPhonemeAttention(n_heads, H)
        self.register_buffer("pitch_bins", _bins(*pitch_range, n_bins, pitch_quantization),
                             persistent=False)
        self.register_buffer("energy_bins", _bins(*energy_range, n_bins, energy_quantization),
                             persistent=False)
        self._graphs = _Graphs()
        self.graph_eager = self.graph_captures = self.graph_replays = 0

    @torch.no_grad()
    def reset_like_jax(self, generator=None):
        """The JAX package's phoneme table: N(0, 1)."""
        nn.init.normal_(self.src_emb.weight, generator=generator)

    def forward(self, texts, src_p_len, word_boundary, src_w_len, max_mel_len,
                p_control=1.0, d_control=1.0, mel_mask=None, attn_prior=None,
                pitch_target=None, energy_target=None, duration_target=None):
        """texts [B, P] phoneme ids, src_p_len [B], word_boundary [B, W]
        phones per word, src_w_len [B]; max_mel_len is the static frame
        axis.  e_control does not exist: as in the reference, the energy
        prediction is scaled by p_control.  Training gives the mel mask
        [B, T_mel], the targets (pitch and energy [B, P], durations [B, P]
        in frames) and, for the CTC helper, attn_prior [B, P, T_mel]."""
        inputs = (texts, src_p_len, word_boundary, src_w_len)
        given = (mel_mask, attn_prior, pitch_target, energy_target, duration_target)
        if texts.is_cuda:
            key = self.graph_key(inputs, max_mel_len, p_control, d_control, given)
            if key is not None:
                return self._graphed(key, inputs, max_mel_len, p_control, d_control)
        return self._encode(*inputs, max_mel_len, p_control, d_control, *given)

    def graph_key(self, inputs, max_mel_len, p_control=1.0, d_control=1.0, given=()):
        """The key of the CUDA graph that replays a call on CUDA with these
        arguments, or None where the call runs eagerly: in training, with
        gradients on, with any of `given` (the mel mask, the prior, the
        targets) not None, with a control that is not a number, or while a
        mesh axis is larger than 1 (a graph holds no collective).  The key:
        the inputs' shapes, types and device, the frame axis, the controls
        (constants in the graph) and the TF32 settings, which choose the
        kernels."""
        if (self.training or torch.is_grad_enabled() or any(g is not None for g in given)
                or not all(isinstance(c, (int, float)) for c in (p_control, d_control))
                or data_size() > 1 or model_size() > 1):
            return None
        return (tuple((t.shape, t.dtype) for t in inputs), inputs[0].device, int(max_mel_len),
                float(p_control), float(d_control), torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)

    def _graphed(self, key, inputs, max_mel_len, p_control, d_control):
        """`key`'s call: eager the first time, captured the second, then
        replayed on the current stream, with fresh clones of the outputs."""
        addresses = _addresses(self, [])
        if addresses != self._graphs.addresses:
            self._graphs = _Graphs(addresses)
        graphs = self._graphs
        if key not in graphs.entries:
            graphs.entries[key] = None
            self.graph_eager += 1
            return self._encode(*inputs, max_mel_len, p_control, d_control)
        with torch.cuda.device(inputs[0].device):
            if graphs.entries[key] is None:
                with span("encoder.capture"):
                    graphs.entries[key] = self._capture(inputs, max_mel_len, p_control,
                                                        d_control)
                self.graph_captures += 1
            graph, static_inputs, static_out = graphs.entries[key]
            with span("encoder.replay"):
                for static, t in zip(static_inputs, inputs):
                    static.copy_(t)
                graph.replay()
                self.graph_replays += 1
                return LinguisticEncoderOutput(*(
                    tuple(t.clone() for t in field) if isinstance(field, tuple) else field.clone()
                    for field in static_out))

    def _capture(self, inputs, max_mel_len, p_control, d_control):
        """(graph, static inputs, static outputs) of the body on copies of
        `inputs`, in the encoder's pool, on its capture stream."""
        graphs = self._graphs
        if graphs.pool is None:
            graphs.pool, graphs.stream = torch.cuda.graph_pool_handle(), torch.cuda.Stream()
        static_inputs = tuple(t.clone() for t in inputs)
        # one eager pass on the capture stream first, which gives cuBLAS its
        # workspace for that stream outside the capture
        graphs.stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(graphs.stream):
            self._encode(*static_inputs, max_mel_len, p_control, d_control)
        torch.cuda.current_stream().wait_stream(graphs.stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=graphs.pool, stream=graphs.stream):
            static_out = self._encode(*static_inputs, max_mel_len, p_control, d_control)
        return graph, static_inputs, static_out

    def _encode(self, texts, src_p_len, word_boundary, src_w_len, max_mel_len, p_control,
                d_control, mel_mask=None, attn_prior=None, pitch_target=None,
                energy_target=None, duration_target=None):
        """The encoder's body (`forward`'s arguments)."""
        B, P = texts.shape
        W = word_boundary.shape[1]
        src_p_mask = sequence_mask(src_p_len, P)
        src_w_mask = sequence_mask(src_w_len, W)

        # phoneme encoding; the padding id embeds to zero
        emb = self.src_emb(texts) * (texts > 0)[..., None]
        enc_p = self.phoneme_encoder(emb, src_p_mask[..., None].to(emb.dtype))

        # synthesis picks the embedding bins with the scaled predictions
        pitch_pred = self.pitch_predictor(enc_p, src_p_mask)
        if pitch_target is None:
            pitch_pred = pitch_target = pitch_pred * p_control
        enc_p = enc_p + self.pitch_embedding(
            torch.bucketize(pitch_target, self.pitch_bins, right=True))
        energy_pred = self.energy_predictor(enc_p, src_p_mask)
        if energy_target is None:
            energy_pred = energy_target = energy_pred * p_control
        enc_p = enc_p + self.energy_embedding(
            torch.bucketize(energy_target, self.energy_bins, right=True))

        # word encoding
        src_w_seq = word_level_pooling(enc_p, word_boundary, W, reduce="mean")
        enc_w = self.word_encoder(src_w_seq, src_w_mask[..., None].to(enc_p.dtype))

        # word durations: pool phoneme durations in the exp domain
        log_dur_p = self.duration_predictor(enc_p, src_p_mask)
        dur_w_sum = word_level_pooling(
            torch.exp(log_dur_p)[..., None], word_boundary, W, reduce="sum")[..., 0]
        log_dur_w_pred = torch.log(torch.clamp(dur_w_sum, min=1e-8)) * src_w_mask
        if duration_target is not None:
            dur_w = torch.round(word_level_pooling(
                duration_target[..., None].float(), word_boundary, W, reduce="sum")[..., 0]).long()
        else:
            dur_w = torch.clamp(torch.round((torch.exp(log_dur_w_pred) - 1) * d_control),
                                min=0).long() * src_w_mask
        x, mel_len = length_regulate(enc_w, dur_w, max_mel_len)
        mel_len = torch.clamp(mel_len, max=max_mel_len)
        if mel_mask is None:
            mel_mask = sequence_mask(mel_len, max_mel_len)

        # word-to-phoneme attention with intra-word relative positions
        map_mask = mapping_mask(dur_w, word_boundary, max_mel_len, P, W)
        q_coef = rel_position_coef(dur_w, max_mel_len, mel_mask)
        kv_coef = rel_position_coef(word_boundary, P, src_p_mask)
        q = x + q_coef[..., None] * self.q_position_enc[:, :max_mel_len]
        k = enc_p + kv_coef[..., None] * self.kv_position_enc[:, :P]
        features, attn, attn_logprob = self.w2p_attn(
            q, k, k, src_p_mask, mel_mask, map_mask, attn_prior)

        return LinguisticEncoderOutput(
            features=features, pitch_pred=pitch_pred, energy_pred=energy_pred,
            log_dur_w_pred=log_dur_w_pred, dur_w_rounded=dur_w,
            mel_len=mel_len, mel_mask=mel_mask, attn=attn, attn_logprob=attn_logprob)
