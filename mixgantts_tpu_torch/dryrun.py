"""The multi-device dryrun (`__graft_entry__.dryrun_multichip` of the JAX
package): n ranks on a (n/2, 2) mesh (n, 1 for an odd n), each phase
printing its OK line:
1. the naive D+G train step, the batch over `data`, the attention, FFN and
   denoiser weights (and their Adam moments) Megatron-sharded over `model`;
2. the shallow D+G train step on the same mesh;
3. data-parallel synthesis (encoder -> decoder -> diffusion -> HiFi-GAN,
   weights replicated, batch rows over `data`), the rows gathered and held
   against rank 0's synthesis of the whole batch with the same noise
   (int16 within 2).
At the JAX package's tiny configuration (`__graft_entry__.py:30-40`: one
encoder and decoder layer, hidden 16, denoiser 1 x 8) and its tiny
HiFi-GAN (stages 8 and 4), one utterance per data shard, on every device:
on CUDA each rank's synthesis launches the denoiser kernel and the folded
MRF kernel, which run those widths with zero channels up to the widths
they are built for.

    python -m mixgantts_tpu_torch.dryrun [N] [--device cuda|cpu]

spawns the N ranks (one process each, a `file://` rendezvous in a
temporary directory) over nccl where every rank has a card of its own and
gloo otherwise (`parallel.choose_backend`).
"""

import argparse
import os
import sys
import tempfile
import time

import numpy as np
import torch

TINY_VOCODER = {"resblock": "1", "upsample_rates": [4, 4], "upsample_kernel_sizes": [8, 8],
                "upsample_initial_channel": 16, "resblock_kernel_sizes": [3],
                "resblock_dilation_sizes": [[1, 3]], "num_mels": 80}
GROUP_TIMEOUT = 120     # seconds, each collective


def tiny_configs():
    """The LJSpeech configs cut to the JAX dryrun's tiny model."""
    from .config import get_configs_of
    pre, cfg, tc = get_configs_of("LJSpeech")
    cfg["transformer"].update(encoder_layer=1, decoder_layer=1, encoder_hidden=16,
                              conv_filter_size=32, conv_kernel_size=3)
    cfg["denoiser"].update(residual_layers=1, residual_channels=8, denoiser_hidden=16)
    cfg["variance_predictor"].update(filter_size=16)
    cfg["max_seq_len"] = 16
    return pre, cfg, tc


def tiny_batch(B, P=8, W=4, T=16):
    """The JAX dryrun's batch (RandomState(0)), numpy."""
    r = np.random.RandomState(0)
    wb = r.randint(1, 3, (B, W)).astype(np.int64)
    src_lens = wb.sum(-1)
    texts = np.zeros((B, P), np.int64)
    for b in range(B):
        texts[b, :src_lens[b]] = r.randint(1, 300, src_lens[b])
    d_targets = np.zeros((B, P), np.int64)
    for b in range(B):
        d_targets[b, :src_lens[b]] = r.randint(1, 3, src_lens[b])
    return dict(speakers=np.zeros((B,), np.int64), texts=texts, src_lens=src_lens,
                word_boundaries=wb, src_w_lens=np.full((B,), W, np.int64),
                mels=r.randn(B, T, 80).astype(np.float32),
                mel_lens=np.minimum(d_targets.sum(-1), T),
                p_targets=r.randn(B, P).astype(np.float32),
                e_targets=r.randn(B, P).astype(np.float32), d_targets=d_targets)


def _model(mode, configs, device):
    from .config import NormStats
    from .models.mixgantts import MixGANTTS
    pre, cfg, _ = configs
    torch.manual_seed(0)
    return MixGANTTS.from_configs(mode, pre, cfg, NormStats.default(80), device=device)


def run_phases(mesh, device):
    """The three phases on this rank of `mesh`."""
    from .models.discriminator import JCUDiscriminator
    from .models.hifigan import HiFiGANGenerator
    from .ops.denoiser_stack import fused_residual_stack
    from .ops.mrf import mrf_stack, mrf_stack_folded
    from .parallel import (
        partition_specs, replicate_state, shard_batch, shard_state, shard_train_step,
    )
    from .train import create_train_state, make_train_step
    import torch.distributed as dist

    D, M = mesh.shape["data"], mesh.shape["model"]
    tag = f"data{D}xmodel{M}"
    lead = mesh.rank == 0
    B = mesh.size                              # as the JAX dryrun: one utterance a device
    batch = tiny_batch(B)
    local = {k: torch.as_tensor(v, device=device)
             for k, v in shard_batch(mesh, batch).items()}
    configs = tiny_configs()
    _, cfg, tc = configs

    for mode in ("naive", "shallow"):
        model = _model(mode, configs, device)
        disc = JCUDiscriminator(n_mels=80, residual_channels=8, n_channels=(4, 8, 8, 4, 1),
                                device=device)
        state = replicate_state(mesh, create_train_state(model, disc, tc, cfg))
        if M > 1:
            shard_state(mesh, state, partition_specs(state, mesh))
        step = shard_train_step(make_train_step(mode, model, disc, cfg, tc), mesh)
        total = float(step(state, local)["total_loss"])
        if not np.isfinite(total):
            raise AssertionError(f"dryrun: the {mode} step gave a non-finite loss")
        if lead:
            print(f"dryrun phase [{mode} train step] mesh={tag} total_loss={total:.4f} OK",
                  flush=True)

    # data-parallel synthesis: each rank its rows, the noise of the whole batch
    model = _model("shallow", configs, device)
    torch.manual_seed(1)
    vocoder = HiFiGANGenerator.from_config(TINY_VOCODER, device=device)
    T = 16
    gen = torch.Generator().manual_seed(3)
    noise = {"start_noise": torch.randn(B, T, 80, generator=gen),
             "step_noises": torch.randn(model.diffusion.num_timesteps, B, T, 80, generator=gen)}

    def synthesize(rows, noise_rows):
        with torch.no_grad():
            out = model(**{k: rows[k] for k in ("speakers", "texts", "src_lens",
                                                 "word_boundaries", "src_w_lens")},
                        max_mel_len=T, noise_override={k: v.to(device) for k, v in
                                                       noise_rows.items()})
            return vocoder(out.mel_pred), out.mel_lens

    r = mesh.coords["data"] * (B // D)
    mine = {"start_noise": noise["start_noise"][r:r + B // D],
            "step_noises": noise["step_noises"][:, r:r + B // D]}
    counters = (fused_residual_stack, mrf_stack, mrf_stack_folded)
    for fn in counters:
        fn.launches = 0
    wav, _ = synthesize(local, mine)
    launches = tuple(fn.launches for fn in counters)
    if torch.device(device).type == "cuda" and not (launches[0] and launches[2]):
        raise AssertionError(f"dryrun: this rank's synthesis launched (denoiser, mrf_stack, "
                             f"mrf_stack_folded) {launches} times; the denoiser and the "
                             f"folded MRF kernel must run")
    parts = [torch.empty_like(wav) for _ in range(mesh.size)]
    dist.all_gather(parts, wav.contiguous())
    rows = torch.cat([parts[d * M] for d in range(D)]).cpu()   # model rank 0 of each data row
    if not torch.isfinite(rows).all():
        raise AssertionError("dryrun: sharded synthesis produced non-finite samples")
    if lead:
        whole, _ = synthesize({k: torch.as_tensor(v, device=device) for k, v in batch.items()},
                              noise)
        diff = (rows - whole.cpu()).abs().max().item() * 32768
        if diff > 2:
            raise AssertionError(f"dryrun: the gathered rows differ from one rank's whole "
                                 f"batch by {diff:.1f} int16 steps")
        print(f"dryrun phase [dp synthesis] mesh={tag} wav={tuple(rows.shape)} "
              f"(against one rank: {diff:.2f} int16 steps) launches={list(launches)} OK",
              flush=True)


def _rank_main(rank, world, device, init_method):
    import torch.distributed as dist
    from .parallel import init_distributed, make_mesh
    if device == "cpu":   # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    init_distributed(device, rank=rank, world_size=world, init_method=init_method,
                     timeout=GROUP_TIMEOUT)
    try:
        model_axis = 2 if world % 2 == 0 and world >= 2 else 1
        run_phases(make_mesh(model_axis=model_axis), torch.device(
            "cpu" if device == "cpu" else f"cuda:{torch.cuda.current_device()}"))
    finally:
        dist.destroy_process_group()


def dryrun_multigpu(n, device="cuda", timeout=600):
    """Run the dryrun on n ranks, one process each (`parallel.start_ranks`);
    raises if a rank fails or the run outlasts `timeout` seconds (every
    rank is then killed).  Prints and returns rank 0's output (its
    synthesis line carries that rank's kernel launches, `launches=[denoiser,
    mrf_stack, mrf_stack_folded]`)."""
    from .parallel.launch import start_ranks
    t0 = time.time()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [repo] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    with tempfile.TemporaryDirectory() as tmp:
        logs = start_ranks([sys.executable, "-u", "-m", "mixgantts_tpu_torch.dryrun",
                            "--device", device], n, tmp, env=env,
                           label=f"dryrun_multigpu({n}, {device!r})").join(timeout)
    print(logs[0], end="", flush=True)
    print(f"dryrun_multigpu({n}): 3 phases (naive step, shallow step, dp synthesis) OK "
          f"in {time.time() - t0:.1f} s", flush=True)
    return logs[0]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("n", nargs="?", type=int, default=2)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--rank", type=int, default=None)
    parser.add_argument("--world", type=int, default=None)
    parser.add_argument("--init", default=None)
    args = parser.parse_args(argv)
    if args.rank is None:
        dryrun_multigpu(args.n, args.device)
    else:
        _rank_main(args.rank, args.world, args.device, args.init)


if __name__ == "__main__":
    main()
