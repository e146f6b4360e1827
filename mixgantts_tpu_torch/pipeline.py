"""Serving pipeline (`mixgantts_tpu/pipeline.py`): a text batch -> int16
waveforms on one GPU.

Linguistic encoder -> aux decoder -> diffusion sampling -> vocoder, with
shapes bucketed as in the JAX package (`tpu.length_buckets` /
`tpu.phone_buckets` in model.yaml), the whole frame bucket vocoded, and the
int16 conversion done on the device.  Device work is asynchronous:
`submit` only enqueues it, and `collect` is the one place that waits for
the device (the copies to the host).

`tpu.compute_dtype: bfloat16` serves bf16 copies of the generator and the
vocoder, as the JAX pipeline casts its `params` (`cast_floats`): every
parameter rounded to bf16, while BatchNorm's running statistics, the
diffusion tables and `spec_min`/`spec_max` (buffers here, `batch_stats` and
constants there) stay fp32; the caller's modules are left as they are.
Activations follow the parameters' type, so the decoder, PostNet, denoiser
and vocoder compute in bf16.  The linguistic encoder's parameters are
rounded to bf16 but held in fp32, so it computes in fp32 on bf16 values: in
the JAX package its fp32 masks and tables promote every encoder product
after the first to fp32, and the predicted durations, which set the
output's length, are computed so.  The int16 conversion is fp32.
"""

import collections
import copy
import warnings

import numpy as np
import torch

from .utils.tools import bucket_length, cast_param, compute_dtype

_GENERATORS_EXHAUSTED = object()


class _Pending:
    """A submitted batch: device-resident outputs and host metadata."""

    __slots__ = ("wav", "mel", "mel_lens", "B", "T")

    def __init__(self, wav, mel, mel_lens, B, T):
        self.wav, self.mel, self.mel_lens = wav, mel, mel_lens
        self.B, self.T = B, T


def cast_parameters(module, dtype, rounded=()):
    """A copy of `module` with every parameter cast by `cast_param` (those
    of the submodules named in `rounded` rounded to `dtype` in their own
    type, the other floating-point ones in `dtype`); every buffer as it is
    (cached stacks are rebuilt: `_apply`)."""
    out = copy.deepcopy(module)
    names = {id(p): name for name, p in out.named_parameters()}

    def cast(t):
        name = names.get(id(t))
        return t if name is None else cast_param(name, t, dtype, rounded)

    return out._apply(cast)


class TTSPipeline:
    """Text -> wav synthesis on the model's device.

    pipeline = TTSPipeline(model, vocoder, preprocess_config, model_config)
    wavs, mel, mel_lens = pipeline(batch)   # B int16 waveforms
    """

    def __init__(self, model, vocoder, preprocess_config, model_config,
                 mesh=None, mel_dtype=torch.bfloat16):
        if mesh is not None:
            raise NotImplementedError("sharded serving over a mesh is not ported yet")
        tpu_cfg = model_config.get("tpu", {}) or {}
        self.compute_dtype = compute_dtype(model_config)
        if self.compute_dtype != torch.float32:
            model = cast_parameters(model, self.compute_dtype, rounded=("linguistic_encoder",))
            vocoder = type(vocoder)(vocoder.name, cast_parameters(vocoder.generator,
                                                                  self.compute_dtype),
                                    vocoder.config)
        self.model = model
        self.vocoder = vocoder
        self.device = next(model.parameters()).device
        # dtype the returned mel is copied to the host in: bf16 halves the
        # copy but quantises (~0.4% rel.); pass torch.float32 when the mel
        # feeds re-vocoding or analysis
        self.mel_dtype = mel_dtype
        self.length_buckets = tuple(tpu_cfg.get("length_buckets", ()))
        self.phone_buckets = tuple(tpu_cfg.get("phone_buckets", ()))
        self.max_seq_len = model_config["max_seq_len"]
        self.hop_length = preprocess_config["preprocessing"]["stft"]["hop_length"]
        self.max_wav_value = float(
            preprocess_config["preprocessing"]["audio"]["max_wav_value"])
        self._call_count = 0

    def __call__(self, batch, p_control=1.0, e_control=1.0, d_control=1.0,
                 generator=None, return_mel=True, noise_override=None):
        """batch: dict with texts [B, P], src_lens, word_boundaries [B, W],
        src_w_lens, speakers, and spker_embeds [B, D] for a model with an
        external speaker embedder.  Returns (wavs, mel, mel_lens): B int16
        waveforms trimmed to each predicted mel length, the mel batch as
        float32 numpy (None with return_mel=False), and the lengths."""
        return self.collect(
            self.submit(batch, p_control, e_control, d_control, generator,
                        noise_override),
            return_mel=return_mel)

    def submit(self, batch, p_control=1.0, e_control=1.0, d_control=1.0,
               generator=None, noise_override=None):
        """Enqueue synthesis of one batch on the device without waiting for
        it; pass the returned handle to `collect`.  `generator` (a
        torch.Generator on the model's device) draws the diffusion noise;
        by default each call seeds one from the pipeline's call counter.
        `noise_override` injects the noise instead ({"start_noise":
        [B, T, M], "step_noises": [S, B, T, M]} at the bucketed T), in the
        compute type."""
        texts = np.asarray(batch["texts"])
        wb = np.asarray(batch["word_boundaries"])
        B = texts.shape[0]
        P = bucket_length(texts.shape[1], self.phone_buckets)
        W = bucket_length(wb.shape[1], self.phone_buckets)
        # frame budget: generous duration headroom, capped at max_seq_len
        T = bucket_length(min(self.max_seq_len, max(64, texts.shape[1] * 16)),
                          self.length_buckets)
        texts = np.pad(texts, ((0, 0), (0, P - texts.shape[1])))
        wb = np.pad(wb, ((0, 0), (0, W - wb.shape[1])))

        def on_device(a, dtype=torch.long):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

        if generator is None:
            generator = torch.Generator(self.device).manual_seed(self._call_count)
            self._call_count += 1
        if noise_override is not None:
            noise_override = {k: on_device(v, self.compute_dtype)
                              for k, v in noise_override.items()}
        spker_embeds = batch.get("spker_embeds")
        if spker_embeds is not None:
            spker_embeds = on_device(spker_embeds, self.compute_dtype)
        with torch.no_grad():
            out = self.model(
                on_device(batch["speakers"]), on_device(texts),
                on_device(batch["src_lens"]), on_device(wb),
                on_device(batch["src_w_lens"]), max_mel_len=T,
                p_control=p_control, e_control=e_control, d_control=d_control,
                noise_override=noise_override, generator=generator,
                spker_embeds=spker_embeds)
            mel = out.mel_pred
            if self.model.mode == "aux":
                # element 0 of aux mode's trace is the clamped normalised mel
                mel = self.model.diffusion.denorm_spec(mel[0])
            wav = self.vocoder(mel)
            wav_i16 = torch.clamp(wav * self.max_wav_value, -self.max_wav_value,
                                  self.max_wav_value - 1).to(torch.int16)
        return _Pending(wav=wav_i16, mel=mel.to(self.mel_dtype),
                        mel_lens=out.mel_lens, B=B, T=T)

    def collect(self, pending, return_mel=True):
        """Copy a `submit` handle's outputs to the host (this waits for the
        device) and trim each waveform.  Same return as `__call__`."""
        B, T = pending.B, pending.T
        wav = pending.wav.cpu().numpy()
        mel = pending.mel.float().cpu().numpy() if return_mel else None
        mel_lens = pending.mel_lens.cpu().numpy()
        if (mel_lens >= T).any():
            # a prediction landing exactly on the cap is indistinguishable
            # from a clamped longer one, hence "may"
            warnings.warn(
                f"synthesis frame budget saturated: predicted mel length hit "
                f"the static cap T={T} (max_seq_len={self.max_seq_len}); the "
                f"tail of the utterance may have been truncated — raise "
                f"max_seq_len or split the text", stacklevel=2)
        wavs = [wav[i, :int(mel_lens[i]) * self.hop_length] for i in range(B)]
        return wavs, mel, mel_lens

    def stream(self, batches, p_control=1.0, e_control=1.0, d_control=1.0,
               return_mel=True, depth=2, generators=None):
        """Yield `__call__`'s result for each batch, in order, keeping up to
        `depth` batches enqueued on the device, so that batch N+1 computes
        while batch N is copied to the host.  `generators` optionally gives
        one torch.Generator per batch."""
        inflight = collections.deque()
        gens = iter(generators) if generators is not None else None
        for batch in batches:
            gen = None
            if gens is not None:
                # a bare next() would raise StopIteration inside this
                # generator, which PEP 479 turns into an opaque RuntimeError
                gen = next(gens, _GENERATORS_EXHAUSTED)
                if gen is _GENERATORS_EXHAUSTED:
                    raise ValueError("stream(): `generators` ran out before "
                                     "`batches` did — pass one per batch")
            inflight.append(self.submit(batch, p_control, e_control, d_control, gen))
            if len(inflight) >= max(1, depth):
                yield self.collect(inflight.popleft(), return_mel=return_mel)
        while inflight:
            yield self.collect(inflight.popleft(), return_mel=return_mel)
