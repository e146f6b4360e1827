"""The linguistic encoder's CUDA graph (`models/linguistic_encoder.py`).

On the CPU: the rule that decides which calls the graph takes
(`LinguisticEncoder.graph_key`) sends training, gradients, every target,
the mel mask, the prior, a tensor control and a mesh axis larger than 1 to
the eager body, and a CPU call runs it too; the counters stay at 0 and the
outputs are the body's.  The addresses that keep a graph valid move with
re-allocation and not with in-place updates, and a copy of the module
starts with no graph.

On the card (marked `gpu`; they skip where no CUDA device is present,
decided inside the fixture), at LJSpeech's width on random weights: the
graph's outputs are bitwise the eager body's at the synthesis cells' keys,
a smaller bucket and controls other than 1; a later replay leaves the
tensors an earlier call returned as they were; the counters read one
eager call and one capture per key and a replay per later call; moving
the parameters drops the graphs (and in-place updates reach them); and
`TTSPipeline.stream` gives the same waveforms two calls deep as one.

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_encoder_graph.py
"""

import copy
import math
import pickle

import numpy as np
import pytest
import torch
import torch.nn as nn

from mixgantts_tpu_torch.models.linguistic_encoder import LinguisticEncoder, _addresses
from mixgantts_tpu_torch.parallel import collectives
from mixgantts_tpu_torch.parallel.mesh import Mesh
from mixgantts_tpu_torch.pipeline import cast_parameters

COUNTERS = ("graph_eager", "graph_captures", "graph_replays")


def counters(enc):
    return tuple(getattr(enc, name) for name in COUNTERS)


def text_batch(B, P, W, seed):
    """B rows of 1..W words of 1-3 phones each (at most P phones), phone
    ids in [1, 300), padded to [B, P] and [B, W]; numpy int64."""
    r = np.random.RandomState(seed)
    texts, wb = np.zeros((B, P), np.int64), np.zeros((B, W), np.int64)
    src_w_lens = r.randint(max(1, W // 2), W + 1, B)
    for b in range(B):
        counts = r.randint(1, 4, src_w_lens[b])
        counts = counts[np.cumsum(counts) <= P]
        src_w_lens[b] = len(counts)
        wb[b, :len(counts)] = counts
        texts[b, :counts.sum()] = r.randint(1, 300, counts.sum())
    return dict(speakers=np.zeros(B, np.int64), texts=texts, src_lens=wb.sum(-1),
                word_boundaries=wb, src_w_lens=src_w_lens.astype(np.int64))


def encoder_inputs(B, P, W, seed, device):
    b = text_batch(B, P, W, seed)
    return tuple(torch.as_tensor(b[k], device=device)
                 for k in ("texts", "src_lens", "word_boundaries", "src_w_lens"))


def fields(out):
    """The output's tensors, the attention pair flattened."""
    return [t for f in out for t in (f if isinstance(f, tuple) else (f,))]


def assert_same(got, want):
    for g, w in zip(fields(got), fields(want), strict=True):
        assert g.dtype == w.dtype and g.shape == w.shape and g.stride() == w.stride()
        assert torch.equal(g, w)


# ---------------------------------------------------------------- the CPU


def tiny_encoder():
    torch.manual_seed(0)
    return LinguisticEncoder(hidden=16, n_layers=1, n_heads=2, conv_kernel_size=3,
                             max_seq_len=64, vp_filter_size=16).eval()


def tiny_targets(B, P, T):
    r = torch.Generator().manual_seed(1)
    return {"mel_mask": torch.arange(T)[None] < torch.tensor([T, T // 2])[:B, None],
            "attn_prior": torch.rand(B, P, T, generator=r),
            "pitch_target": torch.randn(B, P, generator=r),
            "energy_target": torch.randn(B, P, generator=r),
            "duration_target": torch.randint(0, 4, (B, P), generator=r)}


def single_process_mesh(data, model):
    devices = np.empty((data, model), dtype=object)
    devices[...] = torch.device("cpu")
    return Mesh(devices, groups={"data": None, "model": None})


CASES = ["synthesis", "training", "gradients", "tensor_control", "data_mesh", "model_mesh",
         "mel_mask", "attn_prior", "pitch_target", "energy_target", "duration_target"]


@pytest.mark.parametrize("case", CASES)
def test_cpu_calls_take_the_eager_body(case):
    """Every call on the CPU runs the eager body: the counters stay at 0
    and the outputs are the body's, bit for bit.  Outside synthesis the
    rule itself sends the call there (`graph_key` is None), so it would on
    CUDA too."""
    enc = tiny_encoder()
    T = 48
    inputs = encoder_inputs(2, 16, 6, seed=3, device="cpu")
    kwargs = {}
    if case in tiny_targets(2, 16, T):
        kwargs[case] = tiny_targets(2, 16, T)[case]
    if case == "tensor_control":
        kwargs["p_control"] = torch.tensor(1.2)
    if case == "training":
        enc.train()
    mesh = {"data_mesh": single_process_mesh(2, 1),
            "model_mesh": single_process_mesh(1, 2)}.get(case)
    grad = case in ("training", "gradients")

    def call(fn):
        torch.manual_seed(5)   # dropout's draws, in training
        with torch.set_grad_enabled(grad), collectives.use(mesh):
            return fn()

    given = tuple(kwargs.get(k) for k in ("mel_mask", "attn_prior", "pitch_target",
                                          "energy_target", "duration_target"))
    key = call(lambda: enc.graph_key(inputs, T, kwargs.get("p_control", 1.0), 1.0, given))
    assert (key is not None) == (case == "synthesis")
    got = call(lambda: enc(*inputs, T, **kwargs))
    body_kwargs = {k: v for k, v in kwargs.items() if k != "p_control"}
    want = call(lambda: enc._encode(*inputs, T, kwargs.get("p_control", 1.0), 1.0,
                                    **body_kwargs))
    assert_same(got, want)
    assert counters(enc) == (0, 0, 0)


def test_addresses_move_with_reallocation_only():
    """A graph stays valid while the parameters and buffers keep their
    addresses and types: in-place updates keep them; `.to()` and a load
    with `assign=True` move them (the old storages held here, so that no
    new tensor can take an old address)."""
    enc = tiny_encoder()
    before = _addresses(enc, [])
    assert len(before) == len(list(enc.parameters())) + len(list(enc.buffers()))
    with torch.no_grad():
        for p in enc.parameters():
            p.mul_(1.5)
    enc.load_state_dict({k: v.clone() for k, v in enc.state_dict().items()})
    assert _addresses(enc, []) == before
    held = []
    for move in (lambda: enc.to(torch.float64), lambda: enc.to(torch.float32),
                 lambda: enc.load_state_dict({k: v.clone() for k, v in enc.state_dict().items()},
                                             assign=True)):
        last = _addresses(enc, [])
        held.append([t.detach() for t in (*enc.parameters(), *enc.buffers())])
        move()
        assert _addresses(enc, []) != last


@pytest.mark.parametrize("how", ["deepcopy", "pickle", "cast_parameters"])
def test_a_copy_starts_with_no_graph(how):
    enc = tiny_encoder()
    enc._graphs.entries["key"] = None
    enc._graphs.addresses = _addresses(enc, [])
    if how == "deepcopy":
        other = copy.deepcopy(enc)
    elif how == "pickle":
        other = pickle.loads(pickle.dumps(enc))
    else:
        other = cast_parameters(enc, torch.bfloat16, rounded=("",))
    assert other._graphs.entries == {} and other._graphs.addresses is None
    assert enc._graphs.entries == {"key": None}


# ---------------------------------------------------------------- the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def lj_encoder(device, seed=0):
    """The LJSpeech configuration's encoder on random weights, its
    duration predictor biased to ~6 frames a phone, as a trained one
    predicts."""
    torch.manual_seed(seed)
    enc = LinguisticEncoder(hidden=256, n_layers=4, n_heads=2, conv_kernel_size=9,
                            window_size=4, max_seq_len=1000, vp_filter_size=256,
                            vp_kernel_size=3)
    with torch.no_grad():
        enc.duration_predictor.linear_layer.bias.fill_(math.log(7.0))
    return enc.to(device).eval()


def eager(enc, inputs, T, p=1.0, d=1.0):
    with torch.no_grad():
        return enc._encode(*inputs, T, p, d)


def graphed(enc, inputs, T, p=1.0, d=1.0):
    with torch.no_grad():
        return enc(*inputs, T, p_control=p, d_control=d)


# (B, P, W, T): the synthesis cells' keys, and a smaller bucket
KEYS = [(32, 128, 32, 1000), (32, 192, 64, 1000), (4, 64, 16, 512)]


@pytest.mark.gpu
@pytest.mark.parametrize("controls", [(1.0, 1.0), (1.3, 0.8)])
@pytest.mark.parametrize("key", KEYS)
def test_graph_equals_eager_bitwise(cuda, key, controls):
    B, P, W, T = key
    enc = lj_encoder(cuda)
    for call in range(4):
        inputs = encoder_inputs(B, P, W, seed=call, device=cuda)
        got = graphed(enc, inputs, T, *controls)
        assert_same(got, eager(enc, inputs, T, *controls))
        assert counters(enc) == (1, int(call >= 1), call)
    assert int(got.mel_len.min()) > 0


@pytest.mark.gpu
def test_returned_tensors_survive_later_replays(cuda):
    B, P, W, T = KEYS[1]
    enc = lj_encoder(cuda)
    x, y = (encoder_inputs(B, P, W, seed=s, device=cuda) for s in (1, 2))
    graphed(enc, x, T)                          # eager
    first = graphed(enc, x, T)                  # captured and replayed
    kept = [t.clone() for t in fields(first)]
    second = graphed(enc, y, T)                 # replayed on other inputs
    torch.cuda.synchronize()
    for t, k in zip(fields(first), kept):
        assert torch.equal(t, k)
    assert_same(second, eager(enc, y, T))
    assert not torch.equal(first.features, second.features)


@pytest.mark.gpu
def test_one_capture_per_key(cuda):
    enc = lj_encoder(cuda)
    keys = KEYS[:2]
    for round_ in range(3):
        for B, P, W, T in keys:
            graphed(enc, encoder_inputs(B, P, W, seed=round_, device=cuda), T)
        assert counters(enc) == (2, 2 * int(round_ >= 1), 2 * round_)
    # another control is another key
    B, P, W, T = keys[0]
    graphed(enc, encoder_inputs(B, P, W, seed=9, device=cuda), T, 1.1, 1.0)
    assert counters(enc) == (3, 2, 4)


def realloc(enc, how):
    """The encoder (or its copy) after `how`; its parameters move (the old
    storages are held, so that no new tensor can take an old address)."""
    realloc.held = [t.detach() for t in (*enc.parameters(), *enc.buffers())]
    if how == "to_dtype":
        return enc.to(torch.float64).to(torch.float32)
    if how == "to_device":
        return enc.cpu().to("cuda")
    if how == "assign_load":
        enc.load_state_dict({k: v.clone() for k, v in enc.state_dict().items()}, assign=True)
        return enc
    holder = nn.Module()
    holder.linguistic_encoder = enc
    return cast_parameters(holder, torch.bfloat16, rounded=("linguistic_encoder",)
                           ).linguistic_encoder


@pytest.mark.gpu
@pytest.mark.parametrize("how", ["to_dtype", "to_device", "assign_load", "cast_parameters"])
def test_moving_the_parameters_drops_the_graphs(cuda, how):
    B, P, W, T = KEYS[2]
    enc = lj_encoder(cuda)
    for s in range(2):
        graphed(enc, encoder_inputs(B, P, W, seed=s, device=cuda), T)
    assert counters(enc) == (1, 1, 1)
    moved = realloc(enc, how)
    start = counters(moved)
    for s in range(3):
        inputs = encoder_inputs(B, P, W, seed=10 + s, device=cuda)
        assert_same(graphed(moved, inputs, T), eager(moved, inputs, T))
    # eager again, then a new capture on the new addresses
    assert tuple(a - b for a, b in zip(counters(moved), start)) == (1, 1, 2)
    if how == "cast_parameters":   # the original keeps its graph
        inputs = encoder_inputs(B, P, W, seed=20, device=cuda)
        assert_same(graphed(enc, inputs, T), eager(enc, inputs, T))
        assert counters(enc) == (1, 1, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("how", ["optimizer", "load_state_dict"])
def test_in_place_updates_reach_the_graph(cuda, how):
    B, P, W, T = KEYS[2]
    enc = lj_encoder(cuda)
    inputs = encoder_inputs(B, P, W, seed=0, device=cuda)
    for _ in range(2):
        before = graphed(enc, inputs, T)
    if how == "optimizer":
        with torch.no_grad():
            for p in enc.parameters():
                p.mul_(1.01)
    else:
        enc.load_state_dict(lj_encoder(cuda, seed=1).state_dict())
    after = graphed(enc, inputs, T)
    assert counters(enc) == (1, 1, 2)
    assert_same(after, eager(enc, inputs, T))
    assert not torch.equal(after.features, before.features)


@pytest.mark.gpu
def test_stream_two_deep_equals_one_deep(cuda):
    from mixgantts_tpu_torch.flagship import flagship_model
    from mixgantts_tpu_torch.models.vocoder import get_vocoder
    from mixgantts_tpu_torch.pipeline import TTSPipeline

    torch.manual_seed(0)
    model, (pre, cfg, _) = flagship_model("shallow", device=cuda)
    with torch.no_grad():
        model.linguistic_encoder.duration_predictor.linear_layer.bias.fill_(math.log(7.0))
    model.eval()
    pipeline = TTSPipeline(model, get_vocoder(cfg, device=cuda, seed=0), pre, cfg)
    batches = [text_batch(8, 100, 40, seed=s) for s in range(4)]

    def run(depth):
        gens = [torch.Generator(cuda).manual_seed(s) for s in range(len(batches))]
        return [wavs for wavs, _, _ in pipeline.stream(batches, depth=depth, generators=gens)]

    run(1)                                   # eager, then captured
    enc = model.linguistic_encoder
    replays = enc.graph_replays
    one, two = run(1), run(2)
    assert enc.graph_replays - replays == 2 * len(batches)
    for a, b in zip(one, two, strict=True):
        for wa, wb in zip(a, b, strict=True):
            np.testing.assert_array_equal(wa, wb)
