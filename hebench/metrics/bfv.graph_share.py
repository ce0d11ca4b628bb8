"""Percent of the BEHZ multiply bodies that replayed a captured CUDA graph,
over the whole run, warm-up included: replays over replays and eager
bodies, by the program's own counter `rns_behz_cuda.GRAPHS`.  Nothing where
the program keeps no such counter or never used the card."""

import sys


def read(r):
    behz = sys.modules.get("hexl_fpga_tpu_torch.ops.rns_behz_cuda")
    graphs = getattr(behz, "GRAPHS", None)
    if r.op != "bfv_multiply" or graphs is None:
        return None
    if not sys.modules["torch"].cuda.is_initialized():
        return None
    bodies = graphs["replays"] + graphs["eager"]
    return 100.0 * graphs["replays"] / bodies if bodies else None
