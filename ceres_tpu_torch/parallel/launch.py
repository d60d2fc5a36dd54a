"""Run a function on n ranks of a fresh torch.distributed group.

    results = run_ranks(fn, world_size, backend="gloo", device="cuda",
                        timeout=300.0, args=(...))

spawns `world_size` processes (a "spawn" context: each imports `fn`'s
module afresh, so `fn` lives in an importable module), initializes the
default group in each through a `file://` store in a new temporary
directory (no TCP port to race for), and calls fn(*args) there. On the
CPU each rank runs one thread; on the card rank r takes device r modulo
the device count (two ranks on one card need the gloo backend: NCCL
refuses them). Returns every rank's result, in rank order.

If a rank raises, exits with another code than 0, or the deadline
(`timeout` seconds from the start) passes, the others are killed and
run_ranks raises with the ranks' errors: a collective that hangs never
hangs the caller. The backend is the caller's choice; nothing picks one.
start_ranks does the same and returns at once; its join() waits.
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import time
import traceback
from datetime import timedelta


def _rank_main(rank, world_size, backend, device, store, fn, args, timeout,
               out_dir):
    import torch
    import torch.distributed as dist
    path = os.path.join(out_dir, f"rank{rank}")
    try:
        if device == "cpu":
            torch.set_num_threads(1)
        else:
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=store, rank=rank,
                                world_size=world_size,
                                timeout=timedelta(seconds=timeout))
        try:
            result = fn(*args)
        finally:
            dist.destroy_process_group()
        with open(path + ".tmp", "wb") as f:
            pickle.dump(result, f)
        os.replace(path + ".tmp", path + ".pkl")
    except BaseException:
        with open(path + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)


class Ranks:
    """The ranks that start_ranks started: join() waits for them and
    returns their results; kill() ends them."""

    def __init__(self, fn, world_size, backend, device, timeout, args):
        import multiprocessing as mp
        if backend not in ("gloo", "nccl"):
            raise ValueError(f"backend must be 'gloo' or 'nccl', got "
                             f"{backend!r}")
        self.what = f"run_ranks({world_size}, {backend}, {device})"
        self.world_size, self.timeout = world_size, timeout
        ctx = mp.get_context("spawn")
        self.tmp = tempfile.mkdtemp(prefix="ceres_ranks_")
        store = "file://" + os.path.join(self.tmp, "store")
        self.deadline = time.monotonic() + timeout
        self.started = []
        try:
            for r in range(world_size):
                p = ctx.Process(target=_rank_main,
                                args=(r, world_size, backend, device, store,
                                      fn, args, timeout, self.tmp),
                                daemon=True)
                p.start()
                self.started.append(p)
        except BaseException:
            self.kill()
            raise

    def join(self):
        """Every rank's result, in rank order; raises (the others killed)
        if a rank fails or the deadline passes."""
        try:
            failed = None
            while True:
                codes = [p.exitcode for p in self.started]
                if any(c not in (None, 0) for c in codes):
                    failed = "a rank failed"
                    break
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() > self.deadline:
                    failed = (f"the ranks passed their {self.timeout:.0f} s "
                              "deadline")
                    break
                time.sleep(0.05)
            if failed is not None:
                for p in self.started:
                    if p.exitcode is None:
                        p.kill()
                errors = []
                for r, p in enumerate(self.started):
                    p.join(10)
                    err = os.path.join(self.tmp, f"rank{r}.err")
                    text = open(err).read() if os.path.exists(err) else ""
                    errors.append(f"rank {r} (exit code {p.exitcode}):\n"
                                  f"{text}")
                raise RuntimeError(f"{self.what}: {failed}\n"
                                   + "\n".join(errors))
            results = []
            for r in range(self.world_size):
                with open(os.path.join(self.tmp, f"rank{r}.pkl"), "rb") as f:
                    results.append(pickle.load(f))
            return results
        finally:
            self.kill()

    def kill(self):
        """End every rank still running and remove the store."""
        for p in self.started:
            if p.is_alive():
                p.kill()
            p.join(10)
        shutil.rmtree(self.tmp, ignore_errors=True)


def start_ranks(fn, world_size: int, backend: str, device: str = "cuda",
                timeout: float = 300.0, args=()) -> Ranks:
    """Start fn(*args) on `world_size` ranks of a new group and return at
    once (the caller works meanwhile, then calls join())."""
    return Ranks(fn, world_size, backend, device, timeout, args)


def run_ranks(fn, world_size: int, backend: str, device: str = "cuda",
              timeout: float = 300.0, args=()):
    """fn(*args) on `world_size` ranks of a new group (see the module
    docstring); returns the ranks' results."""
    return start_ranks(fn, world_size, backend, device, timeout,
                       args).join()
