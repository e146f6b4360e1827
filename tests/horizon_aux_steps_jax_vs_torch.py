"""The aux drive's first steps in the JAX package and in the port, from one
init on one batch stream, on the CPU.

The long-horizon aux drive (`tests/train_horizon_torch.py`, and the JAX
`tests/train_horizon.py`) logs a guided-attention ("helper") loss that
sits at 0.0307 when the word-to-phoneme attention has gone one-hot.  This
script tells the two packages' training apart from their randomness: it
preprocesses the drive's corpus, takes the batches the train CLI's
scheduler gives the first STEPS steps (seed 0, steps_per_call 8, log step
25), initialises the JAX model as the JAX train CLI does
(`create_train_state(PRNGKey(0))` on the stream's first batch), loads the
same weights into the port (`convert.generator_state_dict`) and runs both
aux train steps side by side, per seed: the JAX state's dropout key and
torch's generator are seeded 100 + seed.  With `--no-dropout` the
configs' dropout rates are 0 and the two runs are the same computation up
to floating-point rounding.
It prints, per seed, the mean helper loss of the second half of the steps
and how many of those steps sit on the plateau (|helper - 0.03073| <
2e-4), and without dropout the two runs' helper and postnet losses every
10 steps.

    python tests/horizon_aux_steps_jax_vs_torch.py [--steps 100] [--seeds 4] [--no-dropout]
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import train_horizon_torch as horizon  # noqa: E402  (puts the repo on sys.path)

PLATEAU = 0.03073   # the helper loss of a one-hot word-to-phoneme attention here


def batch_stream(ws, steps, dropout):
    """Preprocess the aux drive's corpus in `ws` (dropout rates 0 unless
    `dropout`) and return the stream's first batch and the batches of
    steps 1..steps."""
    import yaml

    from mixgantts_tpu_torch.cli import train
    from mixgantts_tpu_torch.config import get_configs_of
    from mixgantts_tpu_torch.data.dataset import AcousticDataset
    drive = horizon.Drive(ws, device="cpu")
    block = horizon.step_block(steps, horizon.SHALLOW_STEPS, steps)
    drive.prepare(False, block)
    if not dropout:
        path = f"{ws}/config/TestCorpus/model.yaml"
        with open(path) as f:
            model = yaml.safe_load(f)
        model["transformer"]["encoder_dropout"] = model["transformer"]["decoder_dropout"] = 0.0
        model["variance_predictor"]["dropout"] = 0.0
        with open(path, "w") as f:
            yaml.dump(model, f)
    cwd = os.getcwd()
    os.chdir(ws)
    try:
        pre, cfg, tc = get_configs_of("TestCorpus")
    finally:
        os.chdir(cwd)
    dataset = AcousticDataset("train.txt", "aux", pre, cfg, tc, sort=True, drop_last=True)
    stream = dataset.batches(group_size=train.GROUP_SIZE, shuffle=True, seed=0)
    first = next(b for b in stream if b is not None)
    periods = [block["log_step"], block["synth_step"], block["val_step"], block["save_step"]]
    batches = [b for event, payload in train.schedule_segments(stream, 8, 1, steps, periods)
               if event == "run" for b in payload]
    return first, batches


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--seeds", type=int, default=4)
    parser.add_argument("--no-dropout", action="store_true")
    args = parser.parse_args(argv)

    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import torch

    from mixgantts_tpu.cli.common import build_discriminator as j_disc
    from mixgantts_tpu.cli.common import build_model as j_model
    from mixgantts_tpu.cli.common import model_batch_of as j_batch
    from mixgantts_tpu.config import get_configs_of as j_configs
    from mixgantts_tpu.train.state import create_train_state as j_state
    from mixgantts_tpu.train.step import make_train_step as j_step
    from mixgantts_tpu_torch.cli.common import build_discriminator, build_model, to_device
    from mixgantts_tpu_torch.config import get_configs_of
    from mixgantts_tpu_torch.convert import generator_state_dict
    from mixgantts_tpu_torch.train import create_train_state, make_train_step

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        ws = os.path.join(tmp, "ws")
        first, batches = batch_stream(ws, args.steps, not args.no_dropout)
        os.chdir(ws)
        try:
            jpre, jcfg, jtc = j_configs("TestCorpus")
            pre, cfg, tc = get_configs_of("TestCorpus")
        finally:
            os.chdir(cwd)
    jmodel, _ = j_model("aux", jpre, jcfg)
    jdisc = j_disc(jpre, jcfg)
    init_batch = dict(j_batch(first), max_mel_len=first["mels"].shape[1])
    jstate0 = j_state(jax.random.PRNGKey(0), jmodel, jdisc, init_batch, jtc, jcfg)
    weights = generator_state_dict(jax.tree_util.tree_map(np.asarray, jstate0.g_params),
                                   jax.tree_util.tree_map(np.asarray, jstate0.g_batch_stats))
    jfn = jax.jit(j_step("aux", jmodel, jdisc, jcfg, jtc))
    cpu = torch.device("cpu")
    for seed in range(1 if args.no_dropout else args.seeds):
        jstate = jstate0.replace(rng=jax.random.PRNGKey(100 + seed))
        torch.manual_seed(100 + seed)
        model, _ = build_model("aux", pre, cfg, device=cpu)
        model.load_state_dict(weights, strict=True)
        disc = build_discriminator(pre, cfg, device=cpu)
        state = create_train_state(model, disc, tc, cfg, restore_step=0,
                                   generator=torch.Generator(cpu).manual_seed(seed))
        pfn = make_train_step("aux", model, disc, cfg, tc)
        rows = []
        for batch in batches:
            jstate, jm = jfn(jstate, j_batch(batch))
            pm = pfn(state, to_device(batch, cpu))
            rows.append([float(m[k]) for m in (jm, pm) for k in ("helper_loss", "postnet_loss")])
        rows = np.array(rows)   # [steps, (jax helper, jax postnet, port helper, port postnet)]
        if args.no_dropout:
            for s in range(9, len(rows), 10):
                print(f"step {s + 1}: helper jax {rows[s, 0]:.5f} port {rows[s, 2]:.5f}; "
                      f"postnet jax {rows[s, 1]:.4f} port {rows[s, 3]:.4f}")
        late = rows[len(rows) // 2:]
        on = (np.abs(late[:, [0, 2]] - PLATEAU) < 2e-4).sum(axis=0)
        print(f"seed {seed}: steps {len(rows) // 2 + 1}-{len(rows)}: helper mean jax "
              f"{late[:, 0].mean():.5f} port {late[:, 2].mean():.5f}; on the plateau jax "
              f"{on[0]}/{len(late)} port {on[1]}/{len(late)}", flush=True)


if __name__ == "__main__":
    main()
