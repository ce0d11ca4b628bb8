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

Two ways to run the ranks:

* `run_ranks`: one thread per rank in this process over one in-memory
  store; the counterpart of the reference's virtual 8-device CPU mesh.
* `spawn_ranks`: one process per rank, started as torchrun starts them.
  Each builds its mesh with `Mesh.from_env`, as a rank started by
  `torchrun --nproc-per-node P` does, over a `TCPStore` that the launcher
  (or torchrun's agent) holds.

Several meshes over one store each take a `prefix` of their own: the gloo
groups of a mesh meet under it, so two meshes never share a group's keys.
A mesh smaller than the world (e.g. {"sp": 2} on ranks 0-1 of 4) is built
as `Mesh(world.store, rank, axes, world.device, prefix=...)` by its ranks
alone.  A rank outside it builds nothing and calls none of its
collectives: it goes on to the next mesh it belongs to, where the others
meet it at that mesh's first collective (or at `barrier`).
"""

from __future__ import annotations

import os
import pickle
import signal
import subprocess
import sys
import threading
import time
import traceback
from datetime import timedelta
from math import prod

import torch
import torch.distributed as dist

# gloo collectives that take a CUDA tensor (a probe on an NVIDIA H100 80GB
# HBM3 under torch 2.x; PERF.md §6); everything else is staged by hand
GLOO_TAKES_CUDA = frozenset({"allreduce", "allgather"})

DEFAULT_TIMEOUT_S = 120.0

# torch's launcher contract (what torchrun sets for each rank)
LAUNCH_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


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
                 timeout_s: float = DEFAULT_TIMEOUT_S, prefix: str = "mesh"):
        self.axes = {str(a): int(s) for a, s in axes.items()}
        self.size = prod(self.axes.values())
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        self.rank = rank
        self.device = default_device(rank, device)
        self.store = store  # another mesh over the same ranks takes it
        self.timeout_s = timeout_s
        coords, r = {}, rank
        for a in reversed(self.axes):
            coords[a] = r % self.axes[a]
            r //= self.axes[a]
        self.coords = {a: coords[a] for a in self.axes}
        self._groups = {}
        for a in self.axes:
            others = ",".join(f"{b}={c}" for b, c in self.coords.items() if b != a)
            self._groups[a] = dist.ProcessGroupGloo(
                dist.PrefixStore(f"{prefix}/{a}/{others}/", store),
                self.coords[a], self.axes[a], timedelta(seconds=timeout_s))
        # per rank: calls by collective, their seconds, the bytes handed to
        # gloo and those staged through host memory by hand (both ways)
        self.stats = {"calls": {}, "seconds": 0.0, "wire_bytes": 0,
                      "host_staged_bytes": 0}

    @classmethod
    def from_env(cls, axes: dict, device=None, timeout_s: float = DEFAULT_TIMEOUT_S,
                 prefix: str = "mesh") -> "Mesh":
        """This rank's mesh from torch's launcher contract, as torchrun sets
        it: RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT.  The
        store is a TCPStore at MASTER_ADDR:MASTER_PORT, joined by torch's
        own env:// rendezvous: the launcher's (torchrun's agent or
        `spawn_ranks`, which set TORCHELASTIC_USE_AGENT_STORE), else rank
        0's.  WORLD_SIZE must be the product of the axes.  The device is
        `device` if given, else cuda:(LOCAL_RANK % cards); with no CUDA
        device and no `device` it raises."""
        missing = [k for k in LAUNCH_ENV if not os.environ.get(k)]
        if missing:
            raise RuntimeError(f"Mesh.from_env: {missing} not set (start the "
                               "ranks with torchrun or spawn_ranks)")
        size, world = prod(int(s) for s in axes.values()), int(os.environ["WORLD_SIZE"])
        if world != size:
            raise ValueError(f"Mesh.from_env: WORLD_SIZE {world} is not the "
                             f"{size} ranks of the axes {dict(axes)}")
        dev = default_device(int(os.environ["LOCAL_RANK"]), device)
        store, rank, _ = next(dist.rendezvous(
            "env://", timeout=timedelta(seconds=timeout_s)))
        return cls(store, rank, axes, dev, timeout_s, prefix)

    def axis_size(self, axis: str) -> int:
        return self.axes[axis]

    def axis_index(self, axis: str) -> int:
        return self.coords[axis]

    def close(self) -> None:
        """Shut the process groups down (every rank closes its own)."""
        for g in self._groups.values():
            g.shutdown()
        self._groups.clear()

    def barrier(self) -> None:
        """Return once every rank of the mesh has called barrier: an
        allreduce of a host zero over each axis in turn (not in `stats`)."""
        zero = torch.zeros(1, dtype=torch.int64)
        for g in self._groups.values():
            g.allreduce([zero]).wait()

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


# ---------------------------------------------------------------------------
# ranks in processes of their own
# ---------------------------------------------------------------------------

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_CHILD_MODULE = "hexl_fpga_tpu_torch.parallel.mesh"
_POLL_S = 0.02
FAIL_GRACE_S = 1.0  # after a rank fails, how long the others may take to report


class RankError(RuntimeError):
    """A rank of `spawn_ranks` raised or died; the message carries its
    traceback (or its exit code)."""

    def __init__(self, rank: int, size: int, detail: str):
        super().__init__(f"rank {rank} of {size} failed:\n{detail}")
        self.rank = rank


def _fn_ref(fn):
    """(module, qualified name, file) by which a child finds fn: a function
    defined at the top level of an importable module (or of the script run
    as __main__, which a child loads from its file)."""
    module, qual = getattr(fn, "__module__", None), getattr(fn, "__qualname__", "")
    if not module or not qual or "<" in qual:
        raise ValueError(f"spawn_ranks: {fn!r} is not a module-level function "
                         "(a spawned rank finds fn by module and name)")
    path = getattr(sys.modules.get(module), "__file__", None)
    if module == "__main__" and not path:
        raise ValueError("spawn_ranks: fn is in a __main__ without a file")
    return module, qual, path


def _resolve(ref):
    import importlib
    import importlib.util

    module, qual, path = ref
    if module == "__main__":  # the parent's script, loaded under another name
        spec = importlib.util.spec_from_file_location("__rank_main__", path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules["__rank_main__"] = mod
        spec.loader.exec_module(mod)
    else:
        mod = importlib.import_module(module)
    for part in qual.split("."):
        mod = getattr(mod, part)
    return mod


def _build_kernels() -> None:
    """Compile the CUDA kernels (nvcc only: no CUDA context is made) so that
    the ranks load one build instead of each running nvcc."""
    from ..ops import _build, dyadic_cuda, ntt_cuda

    _build.build(ntt_cuda.KERNEL_SOURCE, ntt_cuda.KERNEL_DEPS)
    _build.build(dyadic_cuda.KERNEL_SOURCE)


def _kill(proc: subprocess.Popen) -> None:
    if proc.poll() is None:
        try:
            os.killpg(proc.pid, signal.SIGKILL)  # the rank and whatever it started
        except ProcessLookupError:
            pass
    proc.wait()


def spawn_ranks(fn, axes: dict, device=None, timeout_s: float = DEFAULT_TIMEOUT_S,
                args=()):
    """fn(mesh, *args) on every rank of a mesh with `axes`, one process per
    rank; returns the results (numpy arrays and plain data) in rank order.

    Each rank is `python -m hexl_fpga_tpu_torch.parallel.mesh` in a process group
    of its own, given torch's launcher contract (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT; TORCHELASTIC_USE_AGENT_STORE, as
    under torchrun's agent; OMP_NUM_THREADS=1 unless set, as torchrun does)
    and a TCPStore on 127.0.0.1 that this process holds; it builds its mesh
    by `Mesh.from_env(axes, device, timeout_s)`, calls fn, and sends the
    result back on its stdout (its own prints go to stderr).  fn is named by
    module and function, so it must be defined at a module's top level, and
    args must pickle.  No CUDA device and no `device` raises here, before
    anything starts; for the card the kernels are built first.

    A rank that raises or dies: every rank is killed and RankError raised,
    with that rank's traceback.  Not done within timeout_s: every rank is
    killed and TimeoutError raised.  Every rank is reaped before this
    returns or raises."""
    size = prod(int(s) for s in axes.values())
    if default_device(0, device).type == "cuda":
        _build_kernels()
    body = pickle.dumps({"fn": _fn_ref(fn), "args": tuple(args), "axes": dict(axes),
                         "device": None if device is None else str(device),
                         "timeout_s": timeout_s}, protocol=pickle.HIGHEST_PROTOCOL)
    # the path first, so that the body's references import in the rank
    task = pickle.dumps((list(sys.path), body), protocol=pickle.HIGHEST_PROTOCOL)
    store = dist.TCPStore("127.0.0.1", 0, None, True, timedelta(seconds=timeout_s),
                          wait_for_workers=False)
    base = dict(os.environ, WORLD_SIZE=str(size), LOCAL_WORLD_SIZE=str(size),
                MASTER_ADDR="127.0.0.1", MASTER_PORT=str(store.port),
                TORCHELASTIC_USE_AGENT_STORE="True",
                PYTHONPATH=os.pathsep.join(
                    p for p in (_PKG_ROOT, os.environ.get("PYTHONPATH")) if p))
    base.setdefault("OMP_NUM_THREADS", "1")
    procs, raw, pumps = [], [None] * size, []

    def pump(rank, proc):
        try:  # the task in, then the whole result out
            proc.stdin.write(task)
            proc.stdin.close()
        except BrokenPipeError:
            pass  # the rank died first; its exit code says so
        raw[rank] = proc.stdout.read()

    deadline = time.monotonic() + timeout_s
    try:
        for r in range(size):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", _CHILD_MODULE], stdin=subprocess.PIPE,
                stdout=subprocess.PIPE, env=dict(base, RANK=str(r), LOCAL_RANK=str(r)),
                start_new_session=True))
            pumps.append(threading.Thread(target=pump, args=(r, procs[-1]),
                                          name=f"spawn_ranks-{r}", daemon=True))
            pumps[-1].start()
        results = [None] * size
        pending = set(range(size))
        failed = []  # (sent nothing, when, rank, detail) of the failed ranks
        grace = None
        while pending:
            for r in sorted(pending):
                if pumps[r].is_alive():  # its result is not all in yet
                    continue
                pending.discard(r)
                try:
                    status, value = pickle.loads(raw[r])
                except Exception:  # nothing (or a torn result) came back
                    status, value = "died", None
                if status == "ok":
                    results[r] = value
                elif status == "error":
                    failed.append((False, value[0], r, value[1]))
                else:
                    try:
                        code = procs[r].wait(1.0)
                    except subprocess.TimeoutExpired:
                        code = None  # its stdout closed, but it runs on
                    failed.append((True, time.time(), r,
                                   f"sent no result (exit code {code})"))
            if failed:  # wait a moment for the others that fail on it
                grace = grace or time.monotonic() + FAIL_GRACE_S
                if time.monotonic() > grace:
                    break
            elif time.monotonic() > deadline:
                raise TimeoutError(f"spawn_ranks: ranks {sorted(pending)} of {size} "
                                   f"still running after {timeout_s} s; every rank killed")
            time.sleep(_POLL_S)
        if failed:
            # the cause: a rank that died sending nothing (its peers' errors
            # came from losing it), else the earliest error
            _, _, r, detail = min(failed, key=lambda f: (not f[0], f[1]))
            raise RankError(r, size, detail)
        for p in procs:  # every result is in: give each rank its own exit
            try:
                p.wait(max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass  # killed below
        return results
    finally:
        for p in procs:
            _kill(p)
        for t in pumps:
            t.join()
        for p in procs:
            for f in (p.stdin, p.stdout):
                if f is not None and not f.closed:
                    try:
                        f.close()
                    except BrokenPipeError:
                        pass
        del store


def _rank_main() -> int:
    """A rank of spawn_ranks: the task from stdin, the result to stdout."""
    out_fd = os.dup(1)
    os.dup2(2, 1)  # fn's prints go to stderr; fd out_fd carries the result
    path, body = pickle.loads(sys.stdin.buffer.read())
    sys.path[:0] = [p for p in path if p not in sys.path]
    status, mesh = "error", None
    try:
        task = pickle.loads(body)
        fn = _resolve(task["fn"])
        mesh = Mesh.from_env(task["axes"], task["device"], task["timeout_s"])
        out = pickle.dumps(("ok", fn(mesh, *task["args"])),
                           protocol=pickle.HIGHEST_PROTOCOL)
        status = "ok"
    except Exception:  # sent to the launcher, which raises it
        out = pickle.dumps(("error", (time.time(), traceback.format_exc())))
    # the result goes out before the groups close: a rank that fails takes
    # its peers down with it only once its own error is on its way
    with os.fdopen(out_fd, "wb") as f:
        f.write(out)
    if mesh is not None:
        mesh.close()
    return 0 if status == "ok" else 1

if __name__ == "__main__":
    # run as `python -m`: hand over to the package's own copy of this module
    from hexl_fpga_tpu_torch.parallel import mesh as _mesh

    sys.exit(_mesh._rank_main())
