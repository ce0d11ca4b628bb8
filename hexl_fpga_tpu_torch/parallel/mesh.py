"""An SPMD device mesh over torch.distributed process groups.

The counterpart of the `jax.sharding.Mesh` and the `shard_map` collectives
of `hexl_fpga_tpu/parallel/sharded.py`.  The reference is single-controller:
one program sees every device of the mesh.  Here every rank holds a `Mesh`
of its own (SPMD): its coordinates on the named axes, its device, and one
gloo process group per axis, made of the ranks that share every other
coordinate.  `axis_index`, `psum`, `all_gather` and `ppermute` stand for
`lax.axis_index`, `lax.psum`, `lax.all_gather` and `lax.ppermute` over one
named axis; every rank of the axis group calls them in the same order.

Gloo moves host memory.  The collectives in GLOO_TAKES_CUDA are handed a
CUDA tensor as it is (gloo copies it through the host itself); the others,
and every send and receive, are staged through pinned host memory here, and
their bytes are counted in `stats`.

`run_ranks` runs one function per rank in threads of this process over one
in-memory store: the counterpart of the reference's virtual 8-device CPU
mesh, and how the tests and `chip_smoke.py` (P ranks on one card) drive the
sharded paths.  Ranks in processes of their own give `Mesh` a shared store
(a `torch.distributed.TCPStore`) instead.
"""

from __future__ import annotations

import threading
import time
from datetime import timedelta
from math import prod

import torch
import torch.distributed as dist

# gloo collectives that take a CUDA tensor (a probe on an NVIDIA H100 80GB
# HBM3 under torch 2.x; PERF.md §6); everything else is staged by hand
GLOO_TAKES_CUDA = frozenset({"allreduce", "allgather"})

DEFAULT_TIMEOUT_S = 120.0


def default_device(rank: int, device=None) -> torch.device:
    """The rank's device: `device` if given, else cuda:(rank % cards).  No
    CUDA device and no `device`: raises (no silent CPU fallback)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("Mesh: no CUDA device is available; pass "
                           "device='cpu' to run the plain versions")
    return torch.device("cuda", rank % torch.cuda.device_count())


class Mesh:
    """One rank's view of a mesh with named axes, e.g. {"dp": 2, "mp": 2}
    (row-major: the last axis varies fastest over the ranks, as a
    `jax.sharding.Mesh` over `devices.reshape(2, 2)`)."""

    def __init__(self, store, rank: int, axes: dict, device=None,
                 timeout_s: float = DEFAULT_TIMEOUT_S):
        self.axes = {str(a): int(s) for a, s in axes.items()}
        self.size = prod(self.axes.values())
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        self.rank = rank
        self.device = default_device(rank, device)
        coords, r = {}, rank
        for a in reversed(self.axes):
            coords[a] = r % self.axes[a]
            r //= self.axes[a]
        self.coords = {a: coords[a] for a in self.axes}
        self._groups = {}
        for a in self.axes:
            others = ",".join(f"{b}={c}" for b, c in self.coords.items() if b != a)
            self._groups[a] = dist.ProcessGroupGloo(
                dist.PrefixStore(f"mesh/{a}/{others}/", store),
                self.coords[a], self.axes[a], timedelta(seconds=timeout_s))
        # per rank: calls by collective, their seconds, the bytes handed to
        # gloo and those staged through host memory by hand (both ways)
        self.stats = {"calls": {}, "seconds": 0.0, "wire_bytes": 0,
                      "host_staged_bytes": 0}

    def axis_size(self, axis: str) -> int:
        return self.axes[axis]

    def axis_index(self, axis: str) -> int:
        return self.coords[axis]

    def close(self) -> None:
        """Shut the process groups down (every rank closes its own)."""
        for g in self._groups.values():
            g.shutdown()
        self._groups.clear()

    # -- staging -------------------------------------------------------------

    def _wire(self, op: str, x: torch.Tensor) -> torch.Tensor:
        """x as gloo takes it for `op`: a CUDA tensor of an op outside
        GLOO_TAKES_CUDA copied into pinned host memory (the copy waits for
        the stream)."""
        x = x.contiguous()
        if x.device.type != "cuda" or op in GLOO_TAKES_CUDA:
            return x
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x)
        self.stats["host_staged_bytes"] += host.nbytes
        return host

    def _back(self, y: torch.Tensor, device: torch.device) -> torch.Tensor:
        if y.device == device:
            return y
        self.stats["host_staged_bytes"] += y.nbytes
        return y.to(device, non_blocking=True)

    def _account(self, op: str, t0: float, nbytes: int) -> None:
        calls = self.stats["calls"]
        calls[op] = calls.get(op, 0) + 1
        self.stats["seconds"] += time.perf_counter() - t0
        self.stats["wire_bytes"] += nbytes

    # -- collectives over one axis ---------------------------------------------

    def psum(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum of x over the axis group, on every rank of it.  int64 sums
        wrap: exact only while no sum leaves the int64 range (a caller that
        broadcasts by a masked psum has one non-zero contributor)."""
        t0 = time.perf_counter()
        buf = self._wire("allreduce", x)
        if buf is x:
            buf = x.clone()
        self._groups[axis].allreduce([buf]).wait()
        out = self._back(buf, x.device)
        self._account("psum", t0, buf.nbytes)
        return out

    def all_gather(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """(axis size,) + x.shape: every rank's x in axis order."""
        t0 = time.perf_counter()
        buf = self._wire("allgather", x)
        outs = [torch.empty_like(buf) for _ in range(self.axes[axis])]
        self._groups[axis].allgather([outs], [buf]).wait()
        out = self._back(torch.stack(outs), x.device)
        self._account("all_gather", t0, buf.nbytes)
        return out

    def ppermute(self, x: torch.Tensor, axis: str, perm) -> torch.Tensor:
        """What the rank with (src, me) in perm sent; zeros where no pair
        sends to this rank (lax.ppermute).  Always through host memory."""
        t0 = time.perf_counter()
        me, g = self.coords[axis], self._groups[axis]
        perm = [(int(s), int(d)) for s, d in perm]
        if any(s == d for s, d in perm):
            raise ValueError("ppermute: a rank cannot send to itself")
        buf = self._wire("send", x)
        got = torch.zeros_like(buf)
        sends = [g.send([buf], d, 0) for s, d in perm if s == me]
        recvs = [g.recv([got], s, 0) for s, d in perm if d == me]
        for w in sends + recvs:
            w.wait()
        out = self._back(got, x.device)
        self._account("ppermute", t0, buf.nbytes * len(sends))
        return out


def run_ranks(fn, axes: dict, device=None, timeout_s: float = DEFAULT_TIMEOUT_S):
    """fn(mesh) on every rank of a mesh with `axes`, one thread each, over
    one in-memory store; returns the results in rank order.  Every rank's
    groups are shut down and every thread joined before it returns; the
    first rank's exception is raised."""
    size = prod(int(s) for s in axes.values())
    store = dist.HashStore()
    results, errors = [None] * size, [None] * size

    def body(rank):
        mesh = None
        try:
            mesh = Mesh(store, rank, axes, device, timeout_s)
            results[rank] = fn(mesh)
        except BaseException as e:  # re-raised in the caller's thread below
            errors[rank] = e
        finally:
            if mesh is not None:
                mesh.close()

    threads = [threading.Thread(target=body, args=(r,), name=f"rank{r}")
               for r in range(size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout_s * 4)
    alive = [t.name for t in threads if t.is_alive()]
    if alive:
        raise RuntimeError(f"run_ranks: {alive} still running after the timeout")
    for e in errors:
        if e is not None:
            raise e
    return results
