"""Rank bodies of the sharded paths, for ranks as threads or as processes.

`mesh.spawn_ranks` names a rank body by module and function, and pickles
its arguments, so the bodies that `chip_smoke.py` and the tests run in
processes live here, over plain data: a maker takes a rank's `Mesh` and a
spec (numpy arrays, ints) and returns ({name: op}, info), each op a
zero-argument call of the sharded layer on the rank's share.  The same
makers run with `mesh.run_ranks` (threads), so both ways run the same
code on the same inputs.

`counted` runs a maker's ops once to stage tables and keys, then once
counted each, between barriers: the launch counters set to 0 first, then
per rank its own launches (`ntt_cuda.thread_launches`), its process's
counters, the collectives' calls, seconds and bytes, and the milliseconds
of the call ended by a synchronise.  `summarize` folds the ranks' results.
"""

from __future__ import annotations

import functools
import os
import time

import numpy as np
import torch

from ..ops import dyadic_cuda, ntt_cuda, word64 as w
from . import sharded
from .mesh import Mesh


def reset_counts() -> None:
    ntt_cuda.reset_launch_counts()
    dyadic_cuda.reset_launch_counts()


def counts() -> dict:
    """This process's launch counters, nonzero ones only."""
    return {k: v for k, v in {**ntt_cuda.LAUNCHES, **dyadic_cuda.LAUNCHES}.items() if v}


def to_plain(x):
    """Tensors as u64 numpy arrays, sizes as lists (what pickles small)."""
    if isinstance(x, torch.Tensor):
        return w.to_u64_np(x)
    if isinstance(x, torch.Size):
        return list(x)
    if isinstance(x, (list, tuple)):
        return type(x)(to_plain(v) for v in x)
    return x


def run_counted(mesh: Mesh, ops: dict) -> dict:
    """{name: (this rank's output, its counts)}: every op once to stage,
    then each once counted, as the module docstring says."""
    for op in ops.values():
        op()
    done = {}
    for name, op in ops.items():
        mesh.barrier()
        reset_counts()  # ranks as threads share the counters: all reset here
        mesh.stats.update(calls={}, seconds=0.0, wire_bytes=0, host_staged_bytes=0)
        mesh.barrier()
        with ntt_cuda.thread_launches() as mine:
            t0 = time.perf_counter()
            out = op()
            if mesh.device.type == "cuda":
                torch.cuda.synchronize(mesh.device)
            ms = (time.perf_counter() - t0) * 1e3
        mesh.barrier()
        done[name] = (to_plain(out), {
            "ms": ms, "pid": os.getpid(), "process_launches": counts(),
            "launches": {k: v for k, v in mine.items() if v},
            "stats": {**mesh.stats, "calls": dict(mesh.stats["calls"])}})
    return done


def counted(mesh: Mesh, maker, spec) -> dict:
    """A rank body: maker(mesh, spec)'s ops run by run_counted."""
    ops, info = maker(mesh, spec)
    return {"ops": run_counted(mesh, ops), "info": info}


def counted_groups(world: Mesh, groups) -> list:
    """A rank body over several meshes of the world's ranks: for each
    (prefix, axes, maker, spec) in turn a Mesh of `axes` over the world's
    store under `prefix`, and `counted` on it; one result per group."""
    out = []
    for prefix, axes, maker, spec in groups:
        m = Mesh(world.store, world.rank, axes, world.device, world.timeout_s, prefix)
        try:
            out.append(counted(m, maker, spec))
        finally:
            m.close()
    return out


def summarize(per_rank: list) -> dict:
    """{name: (per-rank outputs, summary)} from every rank's `counted`
    result: `ms` the slowest rank's (and each rank's), `launches` the sum over ranks (checked
    against the counters of each process the ranks ran in), the collectives
    of rank 0, their slowest rank's ms, the bytes summed."""
    out = {}
    for name in per_rank[0]["ops"]:
        outs = [r["ops"][name][0] for r in per_rank]
        info = [r["ops"][name][1] for r in per_rank]
        summed, by_pid = {}, {}
        for i in info:
            for k, v in i["launches"].items():
                summed[k] = summed.get(k, 0) + v
            by_pid[i["pid"]] = i["process_launches"]
        processes = {}
        for c in by_pid.values():
            for k, v in c.items():
                processes[k] = processes.get(k, 0) + v
        assert summed == processes, (name, summed, processes)
        out[name] = (outs, {
            "ms": max(i["ms"] for i in info),
            "ms_per_rank": [i["ms"] for i in info],
            "launches": summed,
            "launches_per_rank": [i["launches"] for i in info],
            "collectives_per_rank": info[0]["stats"]["calls"],
            "collective_ms_max_rank": max(i["stats"]["seconds"] for i in info) * 1e3,
            "wire_bytes": sum(i["stats"]["wire_bytes"] for i in info),
            "host_staged_bytes": sum(i["stats"]["host_staged_bytes"] for i in info),
            "processes": len(by_pid),
        })
    return out


# ---------------------------------------------------------------------------
# makers: (mesh, spec) -> ({name: op}, info)
# ---------------------------------------------------------------------------


def dp_ntt(mesh: Mesh, spec):
    """The dp NTT of this rank's rows of spec["x"] (B, n) over axis 'dp'."""
    P, d = mesh.axis_size("dp"), mesh.axis_index("dp")
    rows = spec["x"].shape[0] // P
    x = w.from_u64_np(spec["x"][d * rows:(d + 1) * rows], mesh.device)
    fn = sharded.batch_sharded_fwd_ntt(mesh, "dp", spec["n"], spec["q"])
    return {"batch_sharded_fwd_ntt": functools.partial(fn, x)}, {}


def sp_pair(mesh: Mesh, spec):
    """The sp pair over axis 'sp' on this rank's block: forward of spec["x"],
    inverse of spec["want_f"] (the single card's forward); INTT -> NTT
    chained on the rank tensors is checked once here."""
    n, q = spec["n"], spec["q"]
    P, p = mesh.axis_size("sp"), mesh.axis_index("sp")
    S = n // P
    fwd, inv = sharded.dist_fwd_ntt(mesh, "sp", n, q), sharded.dist_inv_ntt(mesh, "sp", n, q)
    blk, f_blk = (w.from_u64_np(np.ascontiguousarray(a[:, p * S:(p + 1) * S]), mesh.device)
                  for a in (spec["x"], spec["want_f"]))
    assert torch.equal(fwd(inv(f_blk)), f_blk), "INTT -> NTT chained"
    return {"dist_fwd_ntt": lambda: fwd(blk), "dist_inv_ntt": lambda: inv(f_blk)}, {}


def _keyswitch(mesh: Mesh, spec, batch_axis):
    return sharded.ShardedKeySwitch(mesh, "mp", batch_axis, spec["n"], spec["L"],
                                    spec["K"], spec["moduli"], spec.get("plain_modulus"))


def keyswitch(mesh: Mesh, spec):
    """ShardedKeySwitch.run over 'mp' (and 'dp' if the mesh has it) of the
    whole batch spec["rs"], spec["ts"]; info: its comm_report."""
    ks = _keyswitch(mesh, spec, "dp" if "dp" in mesh.axes else None)
    B = len(spec["rs"]) // mesh.axes.get("dp", 1)
    return ({"run": functools.partial(ks.run, spec["rs"], spec["ts"], spec["keys"],
                                      spec["msf"])},
            {"comm_report": ks.comm_report(B)})


def hoisted(mesh: Mesh, spec):
    """hoist, then run_hoisted plain and with the Galois element
    spec["galois"], over 'mp'; info: the comm_report."""
    ks = _keyswitch(mesh, spec, None)
    keyed = (spec["keys"], spec["msf"])
    state = {}

    def hoist():
        state["dec"] = ks.hoist(spec["ts"])
        return state["dec"].data.shape

    return ({"hoist": hoist,
             "run_hoisted": lambda: ks.run_hoisted(state["dec"], spec["rs"], *keyed),
             "run_hoisted galois": lambda: ks.run_hoisted(state["dec"], spec["rs"], *keyed,
                                                          galois=spec["galois"])},
            {"comm_report": ks.comm_report(len(spec["rs"]))})


def psum_of_one(mesh: Mesh, spec):
    """spec["reps"] psums of one value over spec["axis"] (a collective's own
    cost: the call's ms over reps)."""
    one = torch.zeros(1, dtype=torch.int64, device=mesh.device)
    return {"psum": lambda: [mesh.psum(one, spec["axis"]) for _ in range(spec["reps"])][-1]}, {}


def torch_ops(mesh: Mesh, spec):
    """spec["ops"] small torch additions in a row on a (spec["rows"],
    spec["n"]) int64 tensor on the rank's device, each followed by a read of
    one value back to the host if spec["sync"]: the sharded paths' glue
    (and its host reads) with no kernel of the port and no collective."""
    x = torch.zeros((spec["rows"], spec["n"]), dtype=torch.int64, device=mesh.device)

    def op():
        y = x
        for _ in range(spec["ops"]):
            y = y + 1
            if spec["sync"]:
                y[0, 0].item()
        return y[0, :1]

    return {"torch_ops": op}, {}


def collectives(mesh: Mesh, spec):
    """The rank's coordinates and, over each axis in turn, a psum, an
    all_gather and a ppermute (0 -> 1) of [rank + 1, spec["k"]]."""
    x = torch.tensor([mesh.rank + 1, spec["k"]], dtype=torch.int64, device=mesh.device)
    return {"collectives": lambda: (
        dict(mesh.coords), [mesh.psum(x, a) for a in mesh.axes],
        [mesh.all_gather(x, a) for a in mesh.axes],
        [mesh.ppermute(x, a, [(0, 1)]) for a in mesh.axes])}, {}


# ---------------------------------------------------------------------------
# the launcher's fault paths (a rank that raises, dies or hangs)
# ---------------------------------------------------------------------------


def fail_on(mesh: Mesh, rank: int, message: str):
    """Raise ValueError(message) on `rank`; every other rank waits in a
    barrier that rank never reaches."""
    if mesh.rank == rank:
        raise ValueError(message)
    mesh.barrier()


def die_on(mesh: Mesh, rank: int, code: int):
    """End the process of `rank` at once with exit code `code` (no result,
    no traceback); every other rank waits in a barrier."""
    if mesh.rank == rank:
        os._exit(code)
    mesh.barrier()


def stall(mesh: Mesh, rank: int, seconds: float):
    """Sleep `seconds` on `rank`; every other rank returns at once."""
    if mesh.rank == rank:
        time.sleep(seconds)
    return mesh.rank
