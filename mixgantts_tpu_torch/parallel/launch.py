"""Spawning the ranks of a multi-process run on one host, where torchrun
is not the launcher (the dryrun, the tests, the GPU smoke script).

`start_ranks(argv, world, workdir)` starts `world` processes of `argv`,
rank r with `--rank r --world <world> --init file://<workdir>/rendezvous`
appended (the rank hands them to `mesh.init_distributed`) and its output
in `<workdir>/rank<r>.log`.  `Ranks.join(timeout)` waits for them; if one
fails or the run outlasts `timeout` seconds, every rank still running is
killed and the error carries the failed ranks' log tails.
"""

import os
import subprocess
import time


class Ranks:
    """The processes of `start_ranks`."""

    def __init__(self, procs, logs, label):
        self.procs, self.logs, self.label = procs, logs, label

    def join(self, timeout):
        """Wait up to `timeout` seconds for every rank and return their
        logs in rank order; raise RuntimeError if a rank failed or was
        killed at the limit."""
        deadline = time.time() + timeout
        try:
            for p in self.procs:
                p.wait(timeout=max(1.0, deadline - time.time()))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        texts = []
        for f in self.logs:
            f.seek(0)
            texts.append(f.read())
            f.close()
        failed = [(r, p.returncode) for r, p in enumerate(self.procs) if p.returncode != 0]
        if failed:
            tails = "\n".join(f"rank {r}:\n{texts[r][-3000:]}" for r, _ in failed[:2])
            raise RuntimeError(f"{self.label}: ranks {failed} failed (rc; -9 is a kill at "
                               f"the {timeout} s limit)\n{tails}")
        return texts


def start_ranks(argv, world, workdir, env=None, cwd=None, label=None):
    """Start `world` ranks of the command `argv` (see the module docstring);
    `env` and `cwd` are the processes'.  Returns their `Ranks`."""
    rendezvous = os.path.join(os.path.abspath(workdir), "rendezvous")
    if os.path.exists(rendezvous):   # a FileStore starts from no file
        os.remove(rendezvous)
    init = f"file://{rendezvous}"
    logs = [open(os.path.join(workdir, f"rank{r}.log"), "w+") for r in range(world)]
    procs = [subprocess.Popen(argv + ["--rank", str(r), "--world", str(world), "--init", init],
                              stdout=logs[r], stderr=subprocess.STDOUT, env=env, cwd=cwd)
             for r in range(world)]
    return Ranks(procs, logs, label or " ".join(os.path.basename(a) for a in argv[1:3]))
