"""A pool of spawned ranks that take one case at a time.

`torch.distributed` programs usually start every rank from the command
line (``torchrun``).  A driver that runs many short multi-rank cases —
the port's sharded tests, `chip_smoke.py`'s mesh phase — would pay a
process start (and, on the card, a CUDA context) per case that way.
`RankPool(n, workdir)` spawns `n` processes at once, with the
``spawn`` start method; ``pool.run(world, fn, *args)`` hands one case to ranks
0..world-1, each of which joins a fresh process group over a
`FileStore` in `workdir` (no TCP port), calls ``fn(*args)``, leaves the
group and sends back its result.

The group runs gloo: the pool's ranks share one host, and on the card
they share one device, which NCCL refuses.  A rank's exception fails
the case with every failing rank's traceback; a rank that does not
answer within the case's `timeout`, or that exits, fails it too.  Either way the pool
kills its ranks (a rank may be stuck in a collective) and starts fresh
ones for the next case.  `fn` and its arguments must pickle: a
module-level function (or a ``"module:function"`` name) of a module
the ranks can import, and numpy or plain values.
"""

from __future__ import annotations

import datetime
import importlib
import itertools
import multiprocessing
import os
import queue
import time
import traceback


def _serve(rank: int, tasks, results, threads: int) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(threads)
    while True:
        item = tasks.get()
        if item is None:
            return
        case, store_path, world, fn_name, args, timeout = item
        try:
            dist.init_process_group(
                "gloo", store=dist.FileStore(store_path, world), rank=rank,
                world_size=world,
                timeout=datetime.timedelta(seconds=timeout))
            try:
                # Every rank's mesh is up before any rank may finish a
                # short case and tear its group down under a peer still
                # connecting.
                dist.barrier()
                mod, name = fn_name.split(":")
                out = getattr(importlib.import_module(mod), name)(*args)
            finally:
                dist.destroy_process_group()
            results.put((case, rank, True, out))
        except (Exception, SystemExit):
            results.put((case, rank, False, traceback.format_exc()))


class RankPool:
    """`n` spawned ranks taking cases one at a time (module docstring).
    `threads` is each rank's torch thread count."""

    def __init__(self, n: int, workdir: str, threads: int = 1):
        self.n = n
        self.workdir = workdir
        self.threads = threads
        self._ctx = multiprocessing.get_context("spawn")
        self._cases = itertools.count()
        self._start()     # the ranks import while the caller works on

    def _start(self) -> None:
        self._tasks = [self._ctx.Queue() for _ in range(self.n)]
        self._results = self._ctx.Queue()
        self._procs = [self._ctx.Process(
            target=_serve, args=(r, self._tasks[r], self._results,
                                 self.threads), daemon=True)
            for r in range(self.n)]
        for p in self._procs:
            p.start()

    def run(self, world: int, fn, *args, timeout: float = 120.0) -> list:
        """``fn(*args)`` on ranks 0..world-1 of a fresh gloo group; the
        ranks' results in rank order."""
        if world > self.n:
            raise ValueError(f"{world} ranks asked of a pool of {self.n}")
        if not self._procs:
            self._start()
        if callable(fn):
            fn = f"{fn.__module__}:{fn.__name__}"
        case = next(self._cases)
        store = os.path.join(self.workdir, f"store-{os.getpid()}-{case}")
        for r in range(world):
            self._tasks[r].put((case, store, world, fn, args, timeout))
        got, errors = {}, []
        deadline = time.monotonic() + timeout
        while len(got) + len(errors) < world:
            try:
                c, rank, ok, out = self._results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(self._procs[:world])
                        if p.exitcode is not None]
                if dead or time.monotonic() > deadline:
                    self.close()
                    why = (f"rank(s) {dead} exited" if dead else
                           f"{world - len(got) - len(errors)} rank(s) did "
                           f"not answer within {timeout} s")
                    raise TimeoutError(f"case {fn} on {world} ranks: {why}"
                                       + "".join(f"\n{e}" for e in errors)
                                       ) from None
                continue
            if c != case:
                continue
            if ok:
                got[rank] = out
            else:
                errors.append(f"rank {rank}:\n{out}")
        if errors:
            self.close()
            raise RuntimeError("\n".join(errors))
        return [got[r] for r in range(world)]

    def close(self) -> None:
        """Stop every rank: asked to leave, killed if it does not."""
        for t in getattr(self, "_tasks", []):
            t.put(None)
        for p in self._procs:
            if p.pid is None:         # never started
                continue
            p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join()
        self._procs = []
