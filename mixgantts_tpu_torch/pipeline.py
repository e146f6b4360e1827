"""Serving pipeline (`mixgantts_tpu/pipeline.py`): a text batch -> int16
waveforms on one GPU.

Linguistic encoder -> aux decoder -> diffusion sampling -> vocoder, with
shapes bucketed as in the JAX package (`tpu.length_buckets` /
`tpu.phone_buckets` in model.yaml), the whole frame bucket vocoded, and the
int16 conversion done on the device.  Device work is asynchronous:
`submit` only enqueues it, and `collect` is the one place that waits for
the device (the copies to the host).

With `mesh` (a single-process `parallel.make_mesh(devices)`, or a list of
devices) the pipeline serves batched synthesis data-parallel, as the JAX
pipeline's mesh shards it over `data`: one replica of the generator and
the vocoder per entry (each with its own kernel weight stacks on its
device; an entry may repeat a device), the batch padded up to a multiple
of the replicas by repeating row 0, every replica's share submitted
before any is collected, and the outputs trimmed.  The diffusion noise is
drawn once for the padded batch (`MixGANTTS.inference_noise`) and split,
so a batch that needs no padding gives what the single-device pipeline
gives.

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

from .parallel.mesh import Mesh
from .utils.profiling import span
from .utils.tools import bucket_length, cast_param, compute_dtype

_GENERATORS_EXHAUSTED = object()


class _Pending:
    """A submitted batch: device-resident outputs and host metadata."""

    __slots__ = ("wav", "mel", "mel_lens", "B", "T")

    def __init__(self, wav, mel, mel_lens, B, T):
        self.wav, self.mel, self.mel_lens = wav, mel, mel_lens
        self.B, self.T = B, T


class _ShardedPending:
    """A batch submitted to every replica of a mesh: their handles, and
    the caller's batch size."""

    __slots__ = ("parts", "B")

    def __init__(self, parts, B):
        self.parts, self.B = parts, B


def serving_devices(mesh):
    """The replicas' devices of a serving mesh: a single-process
    `parallel.Mesh` with a model axis of 1 (serving is never
    tensor-parallel), or a list of devices."""
    if isinstance(mesh, Mesh):
        if mesh.multi_process or mesh.shape["model"] != 1:
            raise ValueError(f"a serving mesh is a single-process data mesh (model axis 1), "
                             f"not {mesh}")
        return list(mesh.devices[:, 0])
    if isinstance(mesh, (list, tuple)) and mesh:
        return [torch.device(d) for d in mesh]
    raise TypeError(f"mesh: a parallel.Mesh or a list of devices, not {type(mesh).__name__}")


def _pad_rows(a, pad, dim=0):
    """a (numpy or tensor) with its row 0 along `dim` repeated `pad` times
    at the end."""
    if not pad:
        return a
    if isinstance(a, torch.Tensor):
        first = a.narrow(dim, 0, 1)
        return torch.cat([a] + [first] * pad, dim=dim)
    a = np.asarray(a)
    return np.concatenate([a] + [np.take(a, [0], axis=dim)] * pad, axis=dim)


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
        devices = None if mesh is None else serving_devices(mesh)
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
        # one (generator, vocoder) replica per mesh entry
        self.replicas = None if devices is None else [
            (copy.deepcopy(model).to(d),
             type(vocoder)(vocoder.name, copy.deepcopy(vocoder.generator).to(d), vocoder.config))
            for d in devices]
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
        compute type.  With a mesh, every replica's share is enqueued."""
        with span("pipeline.submit"):
            texts = np.asarray(batch["texts"])
            wb = np.asarray(batch["word_boundaries"])
            B = texts.shape[0]
            P = bucket_length(texts.shape[1], self.phone_buckets)
            W = bucket_length(wb.shape[1], self.phone_buckets)
            # frame budget: generous duration headroom, capped at max_seq_len
            T = bucket_length(min(self.max_seq_len, max(64, texts.shape[1] * 16)),
                              self.length_buckets)
            arrays = dict(speakers=np.asarray(batch["speakers"]),
                          texts=np.pad(texts, ((0, 0), (0, P - texts.shape[1]))),
                          src_lens=np.asarray(batch["src_lens"]),
                          word_boundaries=np.pad(wb, ((0, 0), (0, W - wb.shape[1]))),
                          src_w_lens=np.asarray(batch["src_w_lens"]))
            if batch.get("spker_embeds") is not None:
                arrays["spker_embeds"] = np.asarray(batch["spker_embeds"])
            if generator is None:
                generator = torch.Generator(self.device).manual_seed(self._call_count)
                self._call_count += 1
            if noise_override is not None:
                noise_override = {k: torch.as_tensor(np.asarray(v), dtype=self.compute_dtype)
                                  for k, v in noise_override.items()}
            controls = (p_control, e_control, d_control)
            if self.replicas is None:
                return self._enqueue(self.model, self.vocoder, arrays, T, controls, generator,
                                     noise_override)
            return self._submit_sharded(arrays, B, T, controls, generator, noise_override)

    def _submit_sharded(self, arrays, B, T, controls, generator, noise):
        """Pad the batch to a multiple of the replicas (repeating row 0),
        draw the padded batch's noise once (unless injected), and enqueue
        each replica's rows."""
        n = len(self.replicas)
        pad = (-B) % n
        k = (B + pad) // n
        arrays = {key: _pad_rows(v, pad) for key, v in arrays.items()}
        if noise is not None:
            noise = {key: _pad_rows(v, pad, dim=1 if key == "step_noises" else 0)
                     for key, v in noise.items()}
        elif self.model.mode != "aux":   # aux mode's output is noise-free
            noise = self.model.inference_noise(B + pad, T, generator, self.device)
        parts = []
        for i, (model, vocoder) in enumerate(self.replicas):
            rows = slice(i * k, (i + 1) * k)
            device = next(model.parameters()).device
            part_noise = None if noise is None else {
                key: (v[:, rows] if key == "step_noises" else v[rows]).to(device)
                for key, v in noise.items()}
            parts.append(self._enqueue(
                model, vocoder, {key: v[rows] for key, v in arrays.items()}, T, controls,
                torch.Generator(device).manual_seed(i), part_noise))
        return _ShardedPending(parts, B)

    def _enqueue(self, model, vocoder, arrays, T, controls, generator, noise_override):
        """Enqueue one model and vocoder on their device's rows."""
        device = next(model.parameters()).device

        def on_device(a, dtype=torch.long):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        if noise_override is not None:
            noise_override = {k: v.to(device) for k, v in noise_override.items()}
        spker_embeds = arrays.get("spker_embeds")
        if spker_embeds is not None:
            spker_embeds = on_device(spker_embeds, self.compute_dtype)
        p_control, e_control, d_control = controls
        with torch.no_grad():
            out = model(
                on_device(arrays["speakers"]), on_device(arrays["texts"]),
                on_device(arrays["src_lens"]), on_device(arrays["word_boundaries"]),
                on_device(arrays["src_w_lens"]), max_mel_len=T,
                p_control=p_control, e_control=e_control, d_control=d_control,
                noise_override=noise_override, generator=generator,
                spker_embeds=spker_embeds)
            mel = out.mel_pred
            if model.mode == "aux":
                # element 0 of aux mode's trace is the clamped normalised mel
                mel = model.diffusion.denorm_spec(mel[0])
            wav = vocoder(mel)
            wav_i16 = torch.clamp(wav * self.max_wav_value, -self.max_wav_value,
                                  self.max_wav_value - 1).to(torch.int16)
        return _Pending(wav=wav_i16, mel=mel.to(self.mel_dtype),
                        mel_lens=out.mel_lens, B=len(arrays["texts"]), T=T)

    def collect(self, pending, return_mel=True):
        """Copy a `submit` handle's outputs to the host (this waits for the
        device) and trim each waveform.  Same return as `__call__`."""
        with span("pipeline.collect"):
            if isinstance(pending, _ShardedPending):
                outs = [self.collect(p, return_mel) for p in pending.parts]
                wavs = [w for o in outs for w in o[0]][:pending.B]
                mel = np.concatenate([o[1] for o in outs])[:pending.B] if return_mel else None
                return wavs, mel, np.concatenate([o[2] for o in outs])[:pending.B]
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
