"""Long-horizon GAN training drive of the PyTorch/CUDA port: the
counterpart of `tests/train_horizon.py`, through the port's CLIs on the
card (`python -m mixgantts_tpu_torch.cli.{preprocess,train,synthesize}`
in subprocesses), on the same 24-utterance synthetic corpus and tiny
configs (`tests/torch_horizon_helpers.py`).  It imports nothing of JAX,
flax or `mixgantts_tpu`.

    python tests/train_horizon_torch.py               # aux 1500 -> shallow 1000 -> synthesize
    python tests/train_horizon_torch.py naive         # naive GAN 1500 steps from scratch
    python tests/train_horizon_torch.py multispeaker  # naive, 3 speakers, 4500 steps

Each drive parses the reference-format train log and holds the run to the
JAX script's bars, unchanged:

  * every logged metric is finite at every log step;
  * aux: the postnet loss improves >= 1.5x and the trace mel loss >= 1.05x
    from the first four log windows to the last four;
  * shallow and naive: the LSGAN bands (`check_gan_bands`), the shallow
    mel loss does not diverge, the naive mel rule and the variance
    predictors' floors;
  * the synthesized wav is non-silent, finite, >= 20% of its energy off DC
    and Nyquist, >= 3% in each of the mid and high speech bands;
  * multispeaker: the two speakers' wavs differ by > 5% of the amplitude,
    and the speaker audit on the final checkpoint, in this process on the
    card (`check_speaker_conditioning`): the learned table moved >= 0.5x
    its init scale, its pairwise cosines < 0.9, and a speaker swap moves
    the sampled mel >= 1.5x as much as a noise reswap.

A bar that is missed does not stop the drive: every reading is taken, the
readings and `"passed"` (with the checks that failed) go to
`docs/horizon_torch.json`, `docs/horizon_torch_naive.json` or
`docs/horizon_torch_ms.json`, beside the card's name and power limit
(`nvidia-smi`), the commit (null where the sources that ran differ from
every commit, as an uncommitted tree's do; `base_commit` names the commit
they were changed from), a digest of the sources that ran and each part's
wall time, and the script then exits 1.  The JAX script's plots are
drawn where matplotlib imports.  `val_ids` records the utterances the
run's preprocessing held out, which decide its batches
(`tests/horizon_batches_torch.py` replays them).

The workspaces are `horizon_torch_ws` and `horizon_torch_ms_ws` under the
temporary directory; a finished phase's checkpoint is reused, and an
interrupted naive run resumes from its newest checkpoint, as in the JAX
script.  The stages (`Drive`, `aux_shallow`, `naive_run`) take the step
counts and the device as arguments, so `chip_smoke.py` and the CPU test
(`tests/test_torch_horizon.py`) run them short.
"""

import hashlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))
DOCS = os.path.join(REPO, "docs")   # where the readings go

AUX_STEPS = 1500
SHALLOW_STEPS = 1000
# the multispeaker drive needs a longer horizon (train_horizon.py:58-62)
MS_STEPS = 4500
LOG_STEP = 25
SAVE_STEP = 500
MS_MEL_FLOOR = 1.4  # train_horizon.py:557

LINE = re.compile(
    r"Step (\d+)/\d+, Total Loss: ([-\d.na]+), D_loss: ([-\d.na]+), "
    r"adv_loss: ([-\d.na]+), mel_loss: ([-\d.na]+), "
    r"postnet_loss: ([-\d.na]+), pitch_loss: ([-\d.na]+), "
    r"energy_loss: ([-\d.na]+), duration_loss: ([-\d.na]+), "
    r"helper_loss:([-\d.na]+)")
KEYS = ["step", "total", "D", "adv", "mel", "postnet", "pitch", "energy",
        "duration", "helper"]
CLI = "mixgantts_tpu_torch.cli"


def workspace(multispeaker=False):
    name = "horizon_torch_ms_ws" if multispeaker else "horizon_torch_ws"
    return os.path.join(tempfile.gettempdir(), name)


def step_block(aux, shallow, naive):
    """train.yaml's `step` block: totals, the log and save periods of the
    JAX script (25, 500) cut to divide every total, and no panels or
    validation."""
    every = math.gcd(aux, aux + shallow, naive)
    return {"total_step_aux": aux, "total_step_naive": naive,
            "total_step_shallow": aux + shallow,
            "log_step": math.gcd(LOG_STEP, every), "synth_step": 10 ** 9,
            "val_step": 10 ** 9, "save_step": math.gcd(SAVE_STEP, every)}


class Drive:
    """One horizon workspace and the port's CLIs run in it, each in a
    subprocess on `device` (None: the card, as `python -m` runs them; a
    named device through the CLI's `cli(argv, device=...)`)."""

    def __init__(self, ws, device=None):
        self.ws = ws
        self.device = device
        self.walls = {}

    def prepare(self, multispeaker, step):
        """Write the configs with this drive's step block, and the corpus,
        preprocessed, unless it is there already (the naive and the aux ->
        shallow drives share one)."""
        from torch_horizon_helpers import write_configs, write_corpus
        fresh = not os.path.isdir(f"{self.ws}/preprocessed/mel")
        if fresh:
            shutil.rmtree(self.ws, ignore_errors=True)
            write_corpus(self.ws, multispeaker)
        write_configs(self.ws, multispeaker, step)
        if fresh:
            print("== preprocess ==", flush=True)
            self.run("preprocess", ["--dataset", "TestCorpus"], "pre.log")

    def run(self, cli, argv, log_name, append=False):
        """`python -m mixgantts_tpu_torch.cli.<cli> argv` in the workspace;
        raises SystemExit with the log's end if it fails."""
        if self.device is None:
            cmd = ["-m", f"{CLI}.{cli}"]
        else:
            cmd = ["-c", f"import sys; from {CLI}.{cli} import cli; "
                         f"cli(sys.argv[1:], device={str(self.device)!r})"]
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
        log = os.path.join(self.ws, log_name)
        t0 = time.perf_counter()
        with open(log, "a" if append else "w") as f:
            p = subprocess.run([sys.executable, "-u", *cmd, *argv], cwd=self.ws, stdout=f,
                               stderr=subprocess.STDOUT, timeout=3600, env=env)
        self.walls[log_name[:-4]] = self.walls.get(log_name[:-4], 0.0) + time.perf_counter() - t0
        if p.returncode != 0:
            with open(log) as f:
                print(f.read()[-4000:])
            raise SystemExit(f"{cli} {argv} failed (rc={p.returncode}); see {log}")
        return log

    def val_ids(self):
        """The utterances the preprocess CLI held out of train.txt: its
        split is drawn anew in every run (`random.shuffle`, unseeded, as in
        the JAX package and the reference), so it decides which batches a
        run trains on."""
        with open(f"{self.ws}/preprocessed/val.txt", encoding="utf-8") as f:
            return [line.split("|", 1)[0] for line in f if line.strip()]

    def ckpt_dir(self, mode):
        return f"{self.ws}/output/ckpt/TestCorpus_{'naive' if mode == 'naive' else 'shallow'}"

    def saved_steps(self, mode):
        d = self.ckpt_dir(mode)
        names = os.listdir(d) if os.path.isdir(d) else []
        return sorted(int(n[:-8]) for n in names if n.endswith(".pth.tar") and n[:-8].isdigit())

    def parse_log(self, mode):
        """The train log's rows, the last occurrence of each step (a rerun
        phase appends its rows to the same log.txt)."""
        path = f"{self.ws}/output/log/TestCorpus_{mode}/train/log.txt"
        rows = []
        with open(path) as f:
            for line in f:
                m = LINE.match(line.strip())
                if m:
                    rows.append({k: float(g) for k, g in zip(KEYS, m.groups())})
        by_step = {r["step"]: r for r in rows}
        return [by_step[s] for s in sorted(by_step)]

    def synthesize(self, mode, step, log_name, speaker=None):
        argv = ["--restore_step", str(step), "--model", mode, "--mode", "single",
                "--text", "hello world", "--dataset", "TestCorpus"]
        if speaker is not None:
            argv += ["--speaker_id", str(speaker)]
        self.run("synthesize", argv, log_name)
        return f"{self.ws}/output/result/TestCorpus_{mode}/{step}"


def aux_shallow(drive, aux_steps=AUX_STEPS, shallow_steps=SHALLOW_STEPS):
    """Preprocess, aux training to `aux_steps`, shallow training for
    `shallow_steps` more from the aux checkpoint (each skipped where its
    final checkpoint is there), and synthesis from the last checkpoint.
    Returns (aux rows, shallow rows, result directory)."""
    drive.prepare(False, step_block(aux_steps, shallow_steps, aux_steps))
    if aux_steps not in drive.saved_steps("aux"):
        print(f"== aux {aux_steps} steps ==", flush=True)
        drive.run("train", ["--model", "aux", "--dataset", "TestCorpus"], "aux.log")
    else:
        print(f"== aux checkpoint {aux_steps} present, reusing its run ==")
    final = aux_steps + shallow_steps
    print(f"== shallow {shallow_steps} steps from aux ckpt ==", flush=True)
    if final not in drive.saved_steps("shallow"):
        drive.run("train", ["--model", "shallow", "--dataset", "TestCorpus",
                            "--restore_step", str(aux_steps)], "shallow.log")
    rows = drive.parse_log("shallow")   # aux shares the *_shallow dir
    aux = [r for r in rows if r["step"] <= aux_steps]
    sh = [r for r in rows if r["step"] > aux_steps]
    if not aux or aux[-1]["step"] != aux_steps or not sh or sh[-1]["step"] != final:
        raise SystemExit(f"the train log ends short: {aux[-1:]} {sh[-1:]}")
    print("== synthesize from the final shallow checkpoint ==", flush=True)
    rdir = drive.synthesize("shallow", final, "synth.log")
    return aux, sh, rdir


def naive_run(drive, steps, multispeaker=False):
    """Preprocess and naive training to `steps` (resumed from the newest
    checkpoint of an interrupted run); returns the log's rows."""
    drive.prepare(multispeaker, step_block(steps, steps, steps))
    if steps not in drive.saved_steps("naive"):
        saved = drive.saved_steps("naive")
        resume = ["--restore_step", str(saved[-1])] if saved else []
        drive.run("train", ["--model", "naive", "--dataset", "TestCorpus"] + resume,
                  "naive.log", append=bool(saved))
    rows = drive.parse_log("naive")
    if not rows or rows[-1]["step"] != steps:
        raise SystemExit(f"the train log ends short: {len(rows)} rows, {rows[-1:]}")
    return rows


class Verdict:
    """The bars a drive is held to: each check prints its reading and
    records a miss instead of stopping the drive."""

    def __init__(self):
        self.failed = []

    def check(self, ok, what):
        print(f"{'ok  ' if ok else 'FAIL'} {what}", flush=True)
        if not ok:
            self.failed.append(what)


def all_finite(rows):
    return all(np.isfinite(v) for r in rows for v in r.values())


def window_mean(rows, key, lo, hi):
    vals = [r[key] for r in rows if lo <= r["step"] <= hi]
    return float(np.mean(vals)) if vals else float("nan")


def check_gan_bands(rows, label, verdict):
    """LSGAN sanity bands (train_horizon.py:268-278): neither player
    collapses nor blows up."""
    d_vals = [r["D"] for r in rows]
    adv_vals = [r["adv"] for r in rows]
    d_mean, adv_mean = float(np.mean(d_vals)), float(np.mean(adv_vals))
    verdict.check(0.0 < d_mean < 2.0, f"{label}: 0 < mean D {d_mean:.4f} < 2")
    verdict.check(0.0 < adv_mean < 4.0, f"{label}: 0 < mean adv {adv_mean:.4f} < 4")
    verdict.check(max(d_vals) < 10 and max(adv_vals) < 10,
                  f"{label}: max D {max(d_vals):.4f} and max adv {max(adv_vals):.4f} < 10")
    return d_mean, adv_mean


def read_wav(rdir, name=None):
    """The first wav in `rdir` (starting with `name`, where given) as floats."""
    import wave
    wavs = sorted(f for f in os.listdir(rdir) if f.endswith(".wav")
                  and (name is None or f.startswith(name)))
    if not wavs:
        raise SystemExit(f"no wav {name!r} in {rdir}: {os.listdir(rdir)}")
    with wave.open(os.path.join(rdir, wavs[0])) as w:
        pcm = np.frombuffer(w.readframes(w.getnframes()), dtype=np.int16)
    return pcm.astype(np.float32) / 32768.0


def spectrum(pcm_f):
    """A float wav's std, the share of its energy off DC and Nyquist, and
    the shares in the 300-1000, 1000-4000 and 4000-10000 Hz bands
    (train_horizon.py:224-265)."""
    xc = pcm_f - pcm_f.mean()
    e = np.abs(np.fft.rfft(xc)) ** 2
    freqs = np.fft.rfftfreq(len(xc), 1.0 / 22050)
    bands = [float(e[(freqs >= lo) & (freqs < hi)].sum() / e.sum())
             for lo, hi in ((300, 1000), (1000, 4000), (4000, 10000))]
    return {"wav_samples": int(len(pcm_f)), "wav_std": float(np.std(pcm_f)),
            "wav_interior_energy": float(e[1:-1].sum() / e.sum()), "wav_band_energy": bands}


def check_wav(rdir, verdict, name=None):
    """The JAX script's non-degeneracy checks on the synthesized wav
    (train_horizon.py:224-265); returns the stats, with the float pcm under
    "pcm"."""
    pcm_f = read_wav(rdir, name)
    verdict.check(len(pcm_f) > 1000, f"wav: {len(pcm_f)} samples > 1000")
    verdict.check(bool(np.isfinite(pcm_f).all()), "wav: finite")
    stats = spectrum(pcm_f)
    std, interior, bands = (stats[k] for k in ("wav_std", "wav_interior_energy",
                                               "wav_band_energy"))
    verdict.check(std > 1e-3, f"wav: std {std:.5f} > 1e-3 (not silent)")
    verdict.check(interior > 0.2, f"wav: interior energy {interior:.4f} > 0.2")
    verdict.check(bands[1] >= 0.03 and bands[2] >= 0.03,
                  f"wav: mid and high band energies {bands[1]:.4f}, {bands[2]:.4f} >= 0.03")
    return dict(stats, pcm=pcm_f)


def speaker_audit(drive, steps, verdict):
    """The speaker-conditioning audit (train_horizon.py:281-378) on the
    final multispeaker checkpoint, in this process on the drive's device:
    the table the run started from (rebuilt as `cli/train.py` builds it
    from --seed 0), the trained one, and mels sampled at 64 frames with
    seeded generators: speakers 0 and 2 from one seed, speaker 0 from a
    second."""
    import types

    import torch
    import yaml

    from mixgantts_tpu_torch.cli.common import build_model, restore_generator
    from mixgantts_tpu_torch.cli.synthesize import build_single_batch
    from mixgantts_tpu_torch.utils.tools import resolve_device

    device = resolve_device(drive.device)
    cfg = f"{drive.ws}/config/TestCorpus"
    with open(f"{cfg}/preprocess.yaml") as f:
        pre = yaml.safe_load(f)
    with open(f"{cfg}/model.yaml") as f:
        model_cfg = yaml.safe_load(f)
    torch.manual_seed(0)   # the train CLI's default --seed, before it builds G
    model, _ = build_model("naive", pre, model_cfg, device=device)
    init_emb = model.speaker_emb.weight.detach().cpu().numpy().copy()
    restore_generator(model, drive.ckpt_dir("naive"), steps)
    model.eval()
    emb = model.speaker_emb.weight.detach().cpu().numpy()
    cosines = {}
    for a in range(len(emb)):
        for b in range(a + 1, len(emb)):
            cosines[f"{a}-{b}"] = float(np.dot(emb[a], emb[b])
                                        / (np.linalg.norm(emb[a]) * np.linalg.norm(emb[b])))
    moved = float(np.abs(emb - init_emb).mean())
    init_scale = float(np.abs(init_emb).mean())
    batch = build_single_batch(types.SimpleNamespace(text="hello world", speaker_id=0),
                               pre, model_cfg)
    kw = {k: torch.as_tensor(batch[k], device=device)
          for k in ("texts", "src_lens", "word_boundaries", "src_w_lens")}

    def sample(spk, seed):
        with torch.no_grad():
            out = model(speakers=torch.tensor([spk], device=device), max_mel_len=64,
                        generator=torch.Generator(device).manual_seed(seed), **kw)
        T = int(out.mel_lens[0])
        return out.mel_pred[0, :T].float().cpu().numpy()

    m0, m2, m0b = sample(0, 7), sample(2, 7), sample(0, 8)
    cross = float(np.abs(m0 - m2).mean())       # speaker swap, same rng
    within = float(np.abs(m0 - m0b).mean())     # rng swap, same speaker
    ratio = cross / max(within, 1e-9)
    verdict.check(moved >= 0.5 * init_scale,
                  f"speaker table moved {moved:.4f} >= 0.5 x init scale {init_scale:.4f}")
    verdict.check(max(cosines.values()) < 0.9, f"speaker table cosines {cosines} < 0.9")
    verdict.check(ratio >= 1.5, f"mel delta cross {cross:.4f} / rng {within:.4f} = "
                                f"{ratio:.2f} >= 1.5")
    return {"spk_table_cosines": cosines, "spk_table_moved": moved,
            "spk_table_init_scale": init_scale,
            "spk_mel_delta_cross": cross, "spk_mel_delta_rng": within,
            "spk_mel_cross_over_rng": ratio}


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def commit():
    """The commit whose sources ran: git's HEAD where the checkout has no
    change to a tracked file, else None (`source_sha256` names the sources
    that ran; `base_commit` the commit they were changed from, where known)."""
    def git(*argv):
        return subprocess.run(["git", *argv], cwd=REPO, capture_output=True, text=True,
                              check=True, timeout=30).stdout.strip()
    try:
        head = git("rev-parse", "HEAD")
        return None if git("status", "--porcelain", "--untracked-files=no") else head
    except (OSError, subprocess.CalledProcessError):
        return None


def base_commit():
    """The commit the sources that ran were changed from: git's HEAD, else
    MIXGANTTS_BASE_COMMIT (a copy without .git), else None."""
    try:
        return subprocess.run(["git", "rev-parse", "HEAD"], cwd=REPO, capture_output=True,
                              text=True, check=True, timeout=30).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return os.environ.get("MIXGANTTS_BASE_COMMIT")


def source_digest():
    """sha256 of the sources a drive runs: the port's package (.py, .cu,
    .cuh, .yaml) and this script with its helpers, in path order."""
    h = hashlib.sha256()
    paths = [os.path.join(REPO, "tests", n)
             for n in ("train_horizon_torch.py", "torch_horizon_helpers.py")]
    for root, dirs, files in os.walk(os.path.join(REPO, "mixgantts_tpu_torch")):
        dirs[:] = sorted(d for d in dirs if d not in ("_build", "__pycache__"))
        paths += [os.path.join(root, n) for n in files
                  if n.endswith((".py", ".cu", ".cuh", ".yaml"))]
    for p in sorted(paths):
        h.update(os.path.relpath(p, REPO).encode())
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def finish(artifact, stem, verdict, drive, t0, plot):
    """Write docs/<stem>.json (and the plot where matplotlib imports); exit
    1 if a bar was missed."""
    artifact.update(
        val_ids=drive.val_ids(),
        passed=not verdict.failed, failed_checks=verdict.failed, device=gpu_line(),
        commit=commit(), base_commit=base_commit(), source_sha256=source_digest(),
        wall_seconds=dict(drive.walls, total=time.perf_counter() - t0))
    out = os.path.join(DOCS, f"{stem}.json")
    with open(out, "w") as f:
        json.dump(artifact, f, indent=1)
    try:
        import matplotlib
    except ImportError:
        print("matplotlib does not import: no plot")
    else:
        matplotlib.use("Agg")
        plot(artifact, os.path.join(DOCS, f"{stem}.png"))
    print(f"{'PASS' if not verdict.failed else 'FAIL'}: {artifact['device']}, "
          f"{artifact['wall_seconds']['total']:.1f} s; written to {out}")
    if verdict.failed:
        raise SystemExit(f"{len(verdict.failed)} bar(s) missed: {verdict.failed}")


def main(device=None):
    t0 = time.perf_counter()
    drive = Drive(workspace(), device)
    aux, sh, rdir = aux_shallow(drive)
    verdict = Verdict()
    verdict.check(all_finite(aux) and all_finite(sh), "every logged metric is finite")
    aux_stats = {}
    # trace-mel floor 1.05 (train_horizon.py:578-581)
    for key, floor in [("postnet", 1.5), ("mel", 1.05)]:
        early = window_mean(aux, key, 1, 4 * LOG_STEP)
        late = window_mean(aux, key, AUX_STEPS - 4 * LOG_STEP, AUX_STEPS)
        factor = early / late
        verdict.check(factor >= floor, f"aux {key}: early {early:.4f} -> late {late:.4f} "
                                       f"({factor:.2f}x, floor {floor}x)")
        aux_stats[key] = (early, late, factor)
    d_mean, adv_mean = check_gan_bands(sh, "shallow GAN", verdict)
    final = AUX_STEPS + SHALLOW_STEPS
    sh_mel_early = window_mean(sh, "mel", AUX_STEPS, AUX_STEPS + 4 * LOG_STEP)
    sh_mel_late = window_mean(sh, "mel", final - 4 * LOG_STEP, final)
    verdict.check(sh_mel_late < 2.0 * sh_mel_early + 0.1,
                  f"shallow mel: {sh_mel_early:.4f} -> {sh_mel_late:.4f} "
                  f"(< 2x early + 0.1)")
    wav_stats = check_wav(rdir, verdict)
    wav_stats.pop("pcm")
    artifact = {
        "corpus": "synthetic-24utt", "aux_steps": AUX_STEPS,
        "shallow_steps": SHALLOW_STEPS, "log_step": LOG_STEP,
        "aux_postnet_early": aux_stats["postnet"][0],
        "aux_postnet_late": aux_stats["postnet"][1],
        "aux_postnet_improvement": aux_stats["postnet"][2],
        "aux_trace_mel_early": aux_stats["mel"][0],
        "aux_trace_mel_late": aux_stats["mel"][1],
        "aux_trace_mel_improvement": aux_stats["mel"][2],
        "shallow_mel_early": sh_mel_early, "shallow_mel_late": sh_mel_late,
        "shallow_D_mean": d_mean, "shallow_adv_mean": adv_mean,
        "aux_trajectory": aux, "shallow_trajectory": sh,
        "all_metrics_finite": all_finite(aux) and all_finite(sh),
    }
    artifact.update(wav_stats)
    finish(artifact, "horizon_torch", verdict, drive, t0, write_plot)


def run_naive(multispeaker=False, device=None):
    """Naive GAN from scratch for AUX_STEPS steps (MS_STEPS on the
    3-speaker corpus with the learned speaker table), then synthesis
    through the sampling loop and, for multispeaker, a per-speaker wav
    pair and the speaker audit (train_horizon.py:380-518)."""
    t0 = time.perf_counter()
    tag = "multispeaker" if multispeaker else "naive"
    steps = MS_STEPS if multispeaker else AUX_STEPS
    drive = Drive(workspace(multispeaker), device)
    print(f"== {tag} naive-GAN {steps} steps from scratch ==", flush=True)
    rows = naive_run(drive, steps, multispeaker)
    verdict = Verdict()
    verdict.check(all_finite(rows), "every logged metric is finite")
    d_mean, adv_mean = check_gan_bands(rows, "naive GAN", verdict)
    early = window_mean(rows, "mel", 1, 4 * LOG_STEP)
    late = window_mean(rows, "mel", steps - 4 * LOG_STEP, steps)
    factor = early / late
    if multispeaker:
        verdict.check(factor >= MS_MEL_FLOOR, f"naive mel: early {early:.4f} -> late "
                                              f"{late:.4f} ({factor:.2f}x, floor {MS_MEL_FLOOR}x)")
    else:
        verdict.check(late < 1.1 * early, f"naive mel: early {early:.4f} -> late {late:.4f} "
                                          f"(no-divergence bound: late < 1.1x early)")
    trend_stats = {}
    floors = ([("duration", 3.0, 4), ("energy", 3.0, 4), ("pitch", 1.05, 32)]
              if multispeaker else
              [("duration", 5.0, 4), ("energy", 5.0, 4), ("pitch", 1.5, 4)])
    for key, floor, late_windows in floors:
        e0 = window_mean(rows, key, 1, 4 * LOG_STEP)
        e1 = window_mean(rows, key, steps - late_windows * LOG_STEP, steps)
        f = e0 / e1
        verdict.check(f >= floor, f"{tag} {key}: {e0:.4f} -> {e1:.4f} ({f:.2f}x, floor "
                                  f"{floor}x, late window {late_windows * LOG_STEP} steps)")
        trend_stats[key] = (e0, e1, f)

    print(f"== synthesize from the final {tag} checkpoint ==", flush=True)
    if multispeaker:
        wavs = {}
        for spk in (0, 2):   # the same text: only the conditioning differs
            rdir = drive.synthesize("naive", steps, f"synth_spk{spk}.log", speaker=spk)
            wav_stats = check_wav(rdir, verdict, name=f"hello world_{spk}")
            wavs[spk] = wav_stats.pop("pcm")
        n = min(len(wavs[0]), len(wavs[2]))
        diff = float(np.abs(wavs[0][:n] - wavs[2][:n]).mean())
        scale = float(np.abs(wavs[0][:n]).mean() + np.abs(wavs[2][:n]).mean()) / 2
        verdict.check(diff > 0.05 * scale, f"speaker-pair wav mean |delta| {diff:.4f} > 5% of "
                                           f"amplitude {scale:.4f}")
        wav_stats["speaker_pair_wav_delta"] = diff
        wav_stats["speaker_pair_wav_scale"] = scale
        t1 = time.perf_counter()
        wav_stats.update(speaker_audit(drive, steps, verdict))
        drive.walls["speaker_audit"] = time.perf_counter() - t1
    else:
        rdir = drive.synthesize("naive", steps, "synth_naive.log")
        wav_stats = check_wav(rdir, verdict)
        wav_stats.pop("pcm")

    artifact = {
        "corpus": "synthetic-3spk-24utt" if multispeaker else "synthetic-24utt",
        "naive_steps": steps, "log_step": LOG_STEP, "multispeaker": multispeaker,
        "naive_mel_early": early, "naive_mel_late": late,
        "naive_mel_improvement": factor,
        "naive_variance_improvements": {
            k: {"early": v[0], "late": v[1], "factor": v[2]} for k, v in trend_stats.items()},
        "naive_D_mean": d_mean, "naive_adv_mean": adv_mean,
        "naive_trajectory": rows, "all_metrics_finite": all_finite(rows),
    }
    artifact.update(wav_stats)
    finish(artifact, "horizon_torch_ms" if multispeaker else "horizon_torch_naive",
           verdict, drive, t0, write_plot_naive)


PALETTE = ["#2a78d6", "#eb6834", "#1baf7a"]
SURFACE, INK, INK2 = "#fcfcfb", "#0b0b0b", "#52514e"


def _axes(fig, axes):
    fig.patch.set_facecolor(SURFACE)
    for ax in axes:
        ax.set_facecolor(SURFACE)
        ax.grid(True, color="#e4e3df", linewidth=0.7, zorder=0)
        for s in ("top", "right"):
            ax.spines[s].set_visible(False)
        for s in ("left", "bottom"):
            ax.spines[s].set_color("#c9c8c2")
        ax.tick_params(colors=INK2, labelsize=9)
        ax.set_xlabel("step", color=INK2, fontsize=9)


def _curves(ax, rows, curves):
    xs = [r["step"] for r in rows]
    for color, (key, label) in zip(PALETTE, curves):
        ax.plot(xs, [r[key] for r in rows], color=color, lw=2, label=label, zorder=3)
    ax.legend(frameon=False, fontsize=9, labelcolor=INK2)


def write_plot(artifact, path):
    """The aux and shallow loss curves (train_horizon.py:165-212)."""
    import matplotlib.pyplot as plt
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4), dpi=130)
    _axes(fig, (ax1, ax2))
    _curves(ax1, artifact["aux_trajectory"], [("postnet", "postnet (recon)"),
                                              ("mel", "trace mel")])
    ax1.set_title(f"aux phase — postnet {artifact['aux_postnet_improvement']:.2f}x down",
                  color=INK, fontsize=10, loc="left")
    _curves(ax2, artifact["shallow_trajectory"], [("mel", "mel (diffusion)"), ("D", "D loss"),
                                                  ("adv", "G adv")])
    ax2.set_title("shallow GAN phase", color=INK, fontsize=10, loc="left")
    fig.suptitle(f"Long-horizon training, PyTorch port (synthetic 24-utt corpus, "
                 f"{artifact['device']})", color=INK, fontsize=11, x=0.01, ha="left")
    fig.tight_layout(rect=(0, 0, 1, 0.94))
    fig.savefig(path, facecolor=SURFACE)
    plt.close(fig)


def write_plot_naive(artifact, path):
    """The naive run's loss curves (train_horizon.py:521-554)."""
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(6.5, 4), dpi=130)
    _axes(fig, (ax,))
    _curves(ax, artifact["naive_trajectory"], [("mel", "mel (diffusion)"), ("D", "D loss"),
                                               ("adv", "G adv")])
    kind = "3-speaker naive GAN" if artifact.get("multispeaker") else "naive GAN"
    ax.set_title(f"{kind} from scratch, PyTorch port — mel "
                 f"{artifact['naive_mel_improvement']:.2f}x down", color=INK, fontsize=10,
                 loc="left")
    fig.tight_layout()
    fig.savefig(path, facecolor=SURFACE)
    plt.close(fig)


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "naive":
        run_naive()
    elif len(sys.argv) > 1 and sys.argv[1] == "multispeaker":
        run_naive(multispeaker=True)
    elif len(sys.argv) > 1:
        sys.exit(f"unknown mode {sys.argv[1]!r} (expected 'naive' or 'multispeaker', or "
                 f"no argument for the aux->shallow drive)")
    else:
        main()
