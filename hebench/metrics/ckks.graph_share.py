"""Percent of a CKKS cell's op bodies that replayed a captured CUDA graph,
over the whole run, warm-up included: replays over replays and eager
bodies, by the program's own counters.  A matvec cell reads
integrations/ckks.py's LINEAR_TRANSFORMS (the products' bodies); a rotate
cell reads ops/keyswitch_cuda.py's GRAPHS, which counts the keyswitch bodies
of the rotations that go through dispatch_batch's body cache (the cell
keyswitches nothing else).  Nothing where the program keeps no such counter,
counted no body, or never used the card."""

import sys


def read(r):
    if r.op != "ckks" or not sys.modules["torch"].cuda.is_initialized():
        return None
    if r.traffic.get("env", {}).get("HEBENCH_CKKS_OP") == "matvec":
        module, name = "hexl_fpga_tpu_torch.integrations.ckks", "LINEAR_TRANSFORMS"
    else:
        module, name = "hexl_fpga_tpu_torch.ops.keyswitch_cuda", "GRAPHS"
    counts = getattr(sys.modules.get(module), name, None)
    if counts is None:
        return None
    bodies = counts["replays"] + counts["eager"]
    return 100.0 * counts["replays"] / bodies if bodies else None
