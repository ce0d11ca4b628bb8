"""Which gloo collectives take a CUDA tensor, on this machine's torch.

    python -m hexl_fpga_tpu_torch.utils.probe_gloo

Needs a CUDA device.  Two ranks as threads on cuda:0 (parallel/mesh.py's
run_ranks, every tensor handed to gloo as it is) try allreduce, allgather
and broadcast of int64 tensors holding values above 2^53, and check the
results exactly.  Prints one JSON object: per collective `ok`, or the
error's first line.  `parallel.mesh.GLOO_TAKES_CUDA` lists those that
passed; send and recv are never tried with a CUDA tensor (the mesh stages
them through host memory).
"""

from __future__ import annotations

import json
import sys

import torch

from ..parallel import mesh as mesh_mod


def _probe(m):
    g, me = m._groups["x"], m.rank
    base = (1 << 60) + 12345
    x = torch.full((4,), base + me, dtype=torch.int64, device=m.device)
    out = {}

    def attempt(name, fn, want):
        try:
            got = fn()
            torch.cuda.synchronize()
            out[name] = "ok" if got.cpu().tolist() == want else f"wrong {got.tolist()}"
        except RuntimeError as e:
            out[name] = "error: " + str(e).splitlines()[0][:200]

    def allreduce():
        y = x.clone()
        g.allreduce([y]).wait()
        return y

    def allgather():
        outs = [torch.empty_like(x) for _ in range(2)]
        g.allgather([outs], [x]).wait()
        return torch.cat(outs)

    def broadcast():
        y = x.clone()
        g.broadcast(y, 0).wait()
        return y

    attempt("allreduce", allreduce, [2 * base + 1] * 4)
    attempt("allgather", allgather, [base] * 4 + [base + 1] * 4)
    attempt("broadcast", broadcast, [base] * 4)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_gloo: no CUDA device is available", file=sys.stderr)
        return 1
    res = mesh_mod.run_ranks(_probe, {"x": 2}, device="cuda:0")
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "torch": torch.__version__, "ranks": res,
                      "mesh_hands_to_gloo_as_cuda": sorted(mesh_mod.GLOO_TAKES_CUDA)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
