"""Multi-process start-up and the collectives of the parallel modes, the
port of ``dc_tts_tpu/parallel/distributed.py``.

JAX forms one runtime over every process and lets GSPMD place the
collectives; here each process is one rank of a ``torch.distributed``
process group and the parallel modes call the collectives themselves:
NCCL for CUDA tensors, gloo for CPU tensors. ``initialize`` joins this
process to the group; the helpers below take a process group (``None``: a
single process with no group, nothing to exchange).

gloo sends and receives only CPU tensors. When a group's backend is gloo
and the tensors lie on the card (two ranks sharing one card, where NCCL
refuses), every collective here copies through the host. The choice is made
from the group's backend, never by catching an error.

``run_ranks`` spawns a few ranks of one group in fresh processes, joined
by a file store in a temporary directory (no port): the tests and the
smoke use it to run several ranks on one machine.
"""
from __future__ import annotations

import datetime
import os
import queue
import tempfile
import time
import traceback
from typing import Optional, Sequence

import torch
import torch.distributed as dist


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               init_method: Optional[str] = None,
               backend: Optional[str] = None, device="cuda",
               timeout: Optional[float] = None) -> bool:
    """``torch.distributed.init_process_group`` from the arguments, else
    from the environment ``torchrun`` sets (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``).

    coordinator_address is "host:port" (or give ``init_method``, e.g.
    "file:///tmp/store" or "tcp://localhost:29500"). backend defaults to
    NCCL when ``device`` is CUDA and gloo on the CPU; an NCCL failure
    propagates. On CUDA the rank takes card ``LOCAL_RANK`` (else
    process_id modulo the cards) unless ``device`` names one. Returns
    whether a process group is up: a single process with neither
    arguments nor environment forms none (its mesh has one rank and
    exchanges nothing). A second call does nothing.
    """
    if dist.is_initialized():
        return True
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    n = num_processes if num_processes is not None \
        else int(env.get("WORLD_SIZE", "1"))
    pid = process_id if process_id is not None else int(env.get("RANK", "0"))
    if init_method is None and coordinator_address is not None:
        init_method = f"tcp://{coordinator_address}"
    if init_method is None:
        if n != 1:
            raise ValueError(f"{n} processes need a coordinator_address, "
                             "an init_method or torchrun's environment")
        return False
    dev = torch.device(device)
    if dev.type == "cuda":
        index = dev.index if dev.index is not None else int(
            env.get("LOCAL_RANK", pid % torch.cuda.device_count()))
        torch.cuda.set_device(index)
    kw = {}
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout)
    dist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method=init_method, world_size=n, rank=pid, **kw)
    return True


def world() -> tuple[int, int]:
    """(this rank, the number of ranks); (0, 1) without a process group."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def process_info() -> dict:
    """The JAX version's four keys. A rank drives one device."""
    rank, n = world()
    return {"process_index": rank, "process_count": n, "local_devices": 1,
            "global_devices": n}


# ---------------------------------------------------------------------------
# collectives


def _staged(group, tensors: Sequence[torch.Tensor]) -> bool:
    """Whether these tensors go through the host: a gloo group with
    tensors on the card."""
    return (dist.get_backend(group) == "gloo"
            and any(t.is_cuda for t in tensors))


def _flat_(tensors: Sequence[torch.Tensor], group, collective) -> None:
    """Run ``collective`` on one flat buffer of the tensors (through the
    host when staged), then write its values back into them."""
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    buf = flat.cpu() if _staged(group, tensors) else flat
    collective(buf)
    i = 0
    with torch.no_grad():
        for t in tensors:
            t.copy_(buf[i: i + t.numel()].view_as(t))
            i += t.numel()


def all_reduce_sum_(tensors: Sequence[torch.Tensor], group) -> None:
    """Sum each tensor (one dtype for all) over the group, in place."""
    if group is not None and tensors:
        _flat_(tensors, group, lambda b: dist.all_reduce(b, group=group))


def broadcast_(tensors: Sequence[torch.Tensor], src: int, group) -> None:
    """Overwrite each tensor (one dtype for all) with global rank
    ``src``'s, in place."""
    if group is not None and tensors:
        _flat_(tensors, group, lambda b: dist.broadcast(b, src, group=group))


def all_gather_cat(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` (one shape on all) concatenated along ``dim`` (not
    the last) in rank order. It moves bytes: neither NCCL nor gloo takes
    int16 (pcm16 waveforms)."""
    if group is None:
        return t
    staged = _staged(group, [t])
    src = (t.cpu() if staged else t).contiguous().view(torch.uint8)
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).view(t.dtype).to(t.device)


def scatter(out: torch.Tensor, parts: Optional[Sequence[torch.Tensor]],
            src: int, group) -> torch.Tensor:
    """Fill ``out`` with this rank's part of global rank ``src``'s list
    ``parts`` (None on the other ranks), in group-rank order."""
    if group is None:
        return out.copy_(parts[0])
    staged = _staged(group, [out])
    buf = torch.empty(out.shape, dtype=out.dtype) if staged else out
    if parts is not None:
        parts = [(p.cpu() if staged else p).contiguous() for p in parts]
    dist.scatter(buf, parts, src=src, group=group)
    if staged:
        out.copy_(buf)
    return out


def exchange(sends, recvs, group) -> None:
    """Point to point: every send ``(tensor, peer)`` and receive
    ``(tensor to fill, peer)`` (peers are global ranks) posted at once and
    waited for. A chain of blocking sends and receives has an order that
    can deadlock; these have none. An edge rank simply posts fewer."""
    if not sends and not recvs:
        return
    staged = _staged(group, [t for t, _ in list(sends) + list(recvs)])
    ops, back = [], []
    for t, peer in sends:
        ops.append(dist.P2POp(dist.isend, (t.cpu() if staged
                                           else t).contiguous(), peer, group))
    for t, peer in recvs:
        buf = torch.empty(t.shape, dtype=t.dtype) if staged else t
        back.append((t, buf))
        ops.append(dist.P2POp(dist.irecv, buf, peer, group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if staged:
        for t, buf in back:
            t.copy_(buf)


class Pending:
    """A non-blocking send or receive in flight: ``wait()`` completes it
    (and, for a receive through the host, copies into the destination),
    returning the destination. It holds the buffer until then."""

    def __init__(self, work, dst=None, buf=None):
        self.work, self.dst, self.buf = work, dst, buf

    def wait(self):
        self.work.wait()
        if self.dst is not None and self.dst is not self.buf:
            self.dst.copy_(self.buf)
        return self.dst


def isend(t: torch.Tensor, peer: int, group) -> Pending:
    """Start sending ``t`` to global rank ``peer``."""
    buf = (t.cpu() if _staged(group, [t]) else t).contiguous()
    return Pending(dist.isend(buf, peer, group=group), buf=buf)


def irecv(t: torch.Tensor, peer: int, group) -> Pending:
    """Start receiving into ``t`` from global rank ``peer``."""
    buf = torch.empty(t.shape, dtype=t.dtype) if _staged(group, [t]) else t
    return Pending(dist.irecv(buf, peer, group=group), t, buf)


# ---------------------------------------------------------------------------
# spawned ranks


def _rank_main(fn, rank, n, store, backend, device, timeout, args, results):
    torch.set_num_threads(1)
    try:
        initialize(num_processes=n, process_id=rank,
                   init_method=f"file://{store}", backend=backend,
                   device=device, timeout=timeout)
        out = fn(rank, n, *args)
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        return
    results.put((rank, True, out))
    dist.destroy_process_group()


def run_ranks(fn, n: int, args=(), *, backend: str = "gloo", device="cpu",
              timeout: float = 300.0) -> list:
    """``fn(rank, n, *args)`` on ``n`` spawned ranks of one process group
    (``backend`` on ``device``; each rank computes with one CPU thread) ->
    the ranks' return values in rank order. ``fn`` and its arguments and
    results are pickled: a module-level function, plain data back.

    A rank that raises or dies fails the call with its traceback, and so
    does one still running after ``timeout`` seconds (a collective that
    waits on a lost peer hangs rather than fails); the other ranks are
    killed.
    """
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    done = {}
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, n, store, backend, str(device),
                                   timeout, args, results))
                 for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while len(done) < n:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"ranks {sorted(set(range(n)) - set(done))} still "
                        f"running after {timeout:.0f} s")
                try:
                    rank, ok, out = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in done and p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(
                            f"rank {dead[0]} died (exit code "
                            f"{procs[dead[0]].exitcode})") from None
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{out}")
                done[rank] = out
        finally:
            for p in procs:
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [done[r] for r in range(n)]
