"""The comparison that decides `correct`: what the timed path produced,
held against the reference (`reference/`), each number beside its limit
(`limits/<cell>.json`).

Synthesis (per sampled utterance, the widest over the sample):
- `decision_gap`: how far the reference's own pitch, energy and duration
  values lie outside the bins and frame counts the program chose (in bin
  widths and frames); the reference then follows the program's choices.
- `features_err`, `coarse_mel_err`, `mel_err`, `wave_err`: the relative L2
  error, over the utterance's valid frames or samples, of the encoder's
  features, the coarse mel (decoder, mel_linear, PostNet), the mel after
  the shallow diffusion step (the denoiser kernel), and the int16 waveform
  `collect` returned (the vocoder and its MRF kernels).

Training (the first three steps, which set-up drives through the window's
own call):
- `loss_gap`: the widest relative gap of a step's losses.
- `grad_gap`: the first gradient as the optimizer got it (twice Adam's
  first moment after one step, the clip applied), by the worst leaf: the gap
  between the program's norm and the reference's, over the larger of the
  reference's norm of that leaf and of the median leaf.
- `change_gap`: the parameters' change over the three steps, by the worst
  leaf, measured so; leaves whose first reference gradient is under a
  thousandth of the median leaf's are left out (Adam moves them by
  round-off alone).
"""

from typing import NamedTuple

import numpy as np
import torch

from . import core
from .reference.acoustic import Decisions, Generator
from .reference.arith import FULL
from .reference.hifigan import HiFiGAN, to_int16

SYNTH_NUMBERS = ("decision_gap", "features_err", "coarse_mel_err", "mel_err", "wave_err")
LOSSES = ("D_loss", "G_loss", "adv_loss", "mel_loss", "postnet_loss", "fm_loss")


class SynthOutputs(NamedTuple):
    batch: dict          # the host batch submitted
    noise_seed: int      # the seed of the call's diffusion noise generator
    program: dict        # captured tensors: features, coarse, mel, pitch, energy, dur_w
    wavs: list           # int16 waveforms collect returned
    mel_lens: np.ndarray


def rel_err(got, want):
    want = want.double()
    return float((got.double() - want).norm() / want.norm().clamp(min=1e-30))


def _synth_reference(config, weights, device):
    rc = core.ref_config(config)
    G = Generator(rc, config["stats"]).to(device).eval()
    G.load_state_dict(weights["G"], strict=True)
    V = HiFiGAN(config["hifigan"]).to(device).eval()
    V.load_state_dict(weights["V"], strict=True)
    return G, V


def noise_of(seed, B, T, n_mels, steps, device):
    """The diffusion noise the program drew for a call: a generator on the
    device seeded with the call's seed, the start noise then one noise a
    reverse step, in that order and in float32."""
    g = torch.Generator(device).manual_seed(seed)
    start = torch.randn((B, T, n_mels), generator=g, device=device)
    return start, torch.stack([torch.randn((B, T, n_mels), generator=g, device=device)
                               for _ in range(steps)])


def synth_call(G, V, config, batch, noise_seed, decisions, device, arith):
    """The reference's synthesis of one submitted batch, padded and
    bucketed as the serving path pads it."""
    buckets = config["model"]["tpu"]["phone_buckets"]
    texts, wb = batch["texts"], batch["word_boundaries"]
    P, W = core.bucket(texts.shape[1], buckets), core.bucket(wb.shape[1], buckets)
    T = core.frame_bucket(config, texts.shape[1])

    def on(a, width=None):
        a = np.asarray(a)
        if width is not None:
            a = np.pad(a, ((0, 0), (0, width - a.shape[1])))
        return torch.as_tensor(a, dtype=torch.long, device=device)

    start, steps = noise_of(noise_seed, texts.shape[0], T, G.n_mels,
                            G.diffusion.num_timesteps, device)
    with arith.context(), torch.no_grad():
        out = G.synthesize(on(texts, P), on(batch["src_lens"]), on(wb, W),
                           on(batch["src_w_lens"]), T, start, steps, decisions, arith)
        wave = to_int16(V(out.mel, arith),
                        config["preprocess"]["preprocessing"]["audio"]["max_wav_value"])
    return out, wave


def synth_numbers(config, program, ref, ref_wave, wavs, mel_lens):
    """The five synthesis numbers of one call (the widest over its rows)."""
    hop = config["preprocess"]["preprocessing"]["stft"]["hop_length"]
    nums = {"decision_gap": ref.decision_gap, "features_err": 0.0, "coarse_mel_err": 0.0,
            "mel_err": 0.0, "wave_err": 0.0}
    for b in range(ref.mel.shape[0]):
        n = int(ref.mel_len[b])
        if n == 0 or int(mel_lens[b]) != n:
            nums["wave_err"] = max(nums["wave_err"], 1.0 if int(mel_lens[b]) != n else 0.0)
            continue
        for key, name in (("features", "features_err"), ("coarse", "coarse_mel_err"),
                          ("mel", "mel_err")):
            want = ref.features if key == "features" else (ref.coarse_mel if key == "coarse"
                                                           else ref.mel)
            nums[name] = max(nums[name], rel_err(program[key][b, :n].float(), want[b, :n]))
        got = torch.as_tensor(np.asarray(wavs[b])[:n * hop], device=ref_wave.device)
        nums["wave_err"] = max(nums["wave_err"], rel_err(got, ref_wave[b, :n * hop]))
    return nums


def widest(per_call, names):
    return {k: max((n[k] for n in per_call), default=0.0) for k in names}


def judge_synth(config, weights, outputs, device, arith=FULL):
    """The synthesis numbers over the sampled calls: the reference,
    following the program's judged decisions, against what the program
    produced.  With `arith` below FULL, the control: the reference in that
    arithmetic, unforced, stands in the program's place."""
    if not outputs:   # nothing judged is not correct
        return {k: float("inf") for k in SYNTH_NUMBERS}
    G, V = _synth_reference(config, weights, device)
    per_call = []
    for o in outputs:
        program, wavs, mel_lens = o.program, o.wavs, o.mel_lens
        if arith is not FULL:
            ctl, ctl_wave = synth_call(G, V, config, o.batch, o.noise_seed, None, device, arith)
            program = {"features": ctl.features, "coarse": ctl.coarse_mel, "mel": ctl.mel,
                       "pitch": ctl.decisions.pitch, "energy": ctl.decisions.energy,
                       "dur_w": ctl.decisions.dur_w}
            wavs, mel_lens = list(ctl_wave.cpu().numpy()), ctl.mel_len.cpu().numpy()
        decisions = Decisions(program["pitch"].float(), program["energy"].float(),
                              program["dur_w"])
        ref, wave = synth_call(G, V, config, o.batch, o.noise_seed, decisions, device, FULL)
        per_call.append(synth_numbers(config, program, ref, wave, wavs, mel_lens))
    return widest(per_call, SYNTH_NUMBERS)


# --- training ----------------------------------------------------------------------------

def leaf_gap(got, want, keep=None):
    """max over leaves of |got - want| / max(want, median want), leaves
    restricted to `keep` (names)."""
    names = [k for k in want if keep is None or k in keep]
    if not names:
        return 0.0
    median = float(np.median([want[k] for k in names]))
    return max(abs(got[k] - want[k]) / max(want[k], median, 1e-30) for k in names)


def norms(tensors):
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def judge_train(program, ref):
    """The training numbers from the program's readings and the
    reference's: each a dict with `losses` [3 steps of {name: float}],
    `grads` {leaf: first gradient norm} and `change` {leaf: norm of the
    parameters' change over three steps}."""
    loss_gap = max(abs(p[k] - r[k]) / max(abs(r[k]), 1e-30)
                   for p, r in zip(program["losses"], ref["losses"]) for k in LOSSES)
    nums = {"loss_gap": loss_gap, "grad_gap": 0.0, "change_gap": 0.0}
    for model in ("G", "D"):
        g_ref = ref["grads"][model]
        median = float(np.median(list(g_ref.values())))
        moving = {k for k, v in g_ref.items() if v >= 1e-3 * median}
        nums["grad_gap"] = max(nums["grad_gap"], leaf_gap(program["grads"][model], g_ref))
        nums["change_gap"] = max(nums["change_gap"], leaf_gap(program["change"][model],
                                                              ref["change"][model], moving))
    return nums


def verdict(numbers, limits):
    """(correct, [(name, value, limit)]) with every number at or under its
    limit; a number that is not finite fails."""
    rows = [(k, float(numbers[k]), float(limits[k])) for k in limits]
    ok = all(np.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows
