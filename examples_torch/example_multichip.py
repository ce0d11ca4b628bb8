"""Multi-device sharding example: a batch-sharded NTT, a limb-sharded
KeySwitch and a coefficient-sharded NTT over a mesh of ranks.  The port's
counterpart of `examples/example_multichip.py`, at its configuration and
seed.

The reference's mesh is one program over every attached device.  Here each
rank is a process with its own `Mesh` (SPMD).  Run as-is, it starts one rank
per card through `spawn_ranks`, or four ranks on one card when there is one
card:

    python examples_torch/example_multichip.py

Under torchrun each rank builds its mesh from torchrun's environment:

    torchrun --nproc-per-node P examples_torch/example_multichip.py

The axes mirror the reference's parallelism: 'dp' the op batch, 'mp' the
RNS engines of the keyswitch pipeline, 'sp' the coefficients of one long
polynomial.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hexl_fpga_tpu_torch.ops import golden, nt, word64 as w  # noqa: E402
from hexl_fpga_tpu_torch.parallel import rank_ops, sharded  # noqa: E402
from hexl_fpga_tpu_torch.parallel.mesh import (  # noqa: E402
    LAUNCH_ENV, Mesh, spawn_ranks,
)
from hexl_fpga_tpu_torch.utils import vectors  # noqa: E402

N = 1024
RANKS_ON_ONE_CARD = 4
CPU_RANKS = 2  # device "cpu" (the tests): two ranks keep the run short


def rank_body(world: Mesh):
    """One rank's share of the three steps, each checked here bit for bit;
    returns (the steps that ran, this process's kernel launches)."""
    P, rank = world.size, world.rank
    rank_ops.reset_counts()
    steps = []

    # --- batch-sharded forward NTT over 'dp' (zero collectives) -----------
    q = int(nt.generate_primes(1, 45, N)[0])
    a = np.random.default_rng(0).integers(0, q, size=(2 * P, N), dtype=np.uint64)
    fn = sharded.batch_sharded_fwd_ntt(world, "dp", N, q)
    mine = a[2 * rank:2 * rank + 2]
    out = w.to_u64_np(fn(w.from_u64_np(mine, world.device)))
    np.testing.assert_array_equal(out, golden.fwd_ntt(mine, q))
    steps.append(f"batch-sharded NTT over dp={P}: bit-exact")

    # --- RNS-limb-sharded KeySwitch over 'mp' -----------------------------
    L, K = 2, 3
    vec = vectors.make_keyswitch_vector(N, L, K, seed=0, modulus_bits=45)
    mp = Mesh(world.store, rank, {"mp": P}, world.device, world.timeout_s, prefix="mp")
    try:
        ks = sharded.ShardedKeySwitch(mp, "mp", None, N, L, K, vec.moduli)
        got = ks.run(vec.input[None], vec.t_target_iter_ptr[None],
                     vec.key_vectors, vec.modswitch_factors)
    finally:
        mp.close()
    np.testing.assert_array_equal(got[0], vec.expected_output)
    steps.append(f"limb-sharded KeySwitch over mp={P}: bit-exact")

    # --- coefficient-sharded NTT ('sp', the long-polynomial seam) ---------
    if (N // 128) % P == 0 and P >= 2:
        sp = Mesh(world.store, rank, {"sp": P}, world.device, world.timeout_s,
                  prefix="sp")
        try:
            S = N // P
            blk = np.ascontiguousarray(a[:2, rank * S:(rank + 1) * S])
            dfn = sharded.dist_fwd_ntt_mxu(sp, "sp", N, q)
            out = w.to_u64_np(dfn(w.from_u64_np(blk, world.device)))
        finally:
            sp.close()
        np.testing.assert_array_equal(out, golden.fwd_ntt(a[:2], q)[:, rank * S:(rank + 1) * S])
        steps.append(f"coefficient-sharded NTT over sp={P}: bit-exact")
    if world.device.type == "cuda":
        torch.cuda.synchronize(world.device)
    return steps, rank_ops.counts()


def main(device=None):
    """Spawns the ranks (one per card, or four on one card; two for device
    "cpu") and prints rank 0's steps; under torchrun runs this process's
    rank (rank 0 prints).  Returns {"ranks", "launches"}: the kernel
    launches summed over the spawned ranks, or under torchrun this rank's."""
    if all(os.environ.get(k) for k in LAUNCH_ENV):  # a rank under torchrun
        world = Mesh.from_env({"dp": int(os.environ["WORLD_SIZE"])}, device, prefix="dp")
        try:
            per_rank = [rank_body(world)]
        finally:
            world.close()
        P, name = world.size, _device_name(world.device)
        if world.rank != 0:
            return {"ranks": P, "launches": per_rank[0][1]}
    else:
        if device is not None and torch.device(device).type == "cpu":
            P, name = CPU_RANKS, "cpu (the kernels' plain versions)"
        else:
            cards = torch.cuda.device_count()
            if cards == 0:
                raise RuntimeError("no CUDA device is available; pass device='cpu' "
                                   "to run the plain versions")
            P = cards if cards >= 2 else RANKS_ON_ONE_CARD
            name = _device_name(torch.device("cuda", 0))
        per_rank = spawn_ranks(rank_body, {"dp": P}, device=device)
    print(f"{P} ranks on {name}")
    for step in per_rank[0][0]:
        print(step)
    launches = {}
    for _, counts in per_rank:
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    return {"ranks": P, "launches": launches}


def _device_name(device: torch.device) -> str:
    if device.type == "cpu":
        return "cpu (the kernels' plain versions)"
    return f"{torch.cuda.device_count()} x {torch.cuda.get_device_name(device)}"


if __name__ == "__main__":
    main()
