"""Ranks in processes of their own (`parallel.mesh.spawn_ranks`,
`Mesh.from_env`) on the CPU, the kernels' plain versions.

One spawn per world size runs every positive case on meshes of their own
prefix (`rank_ops.counted_groups`): the coordinates and the collectives,
the dp NTT, the sp pair and ShardedKeySwitch on the frozen vector
1024_2_3_3_2_0; each output is held to the same maker run with the ranks
as threads (`run_ranks`), the dp NTT to the reference's on the JAX 8-device
CPU mesh, the KeySwitch to the vector's expected output.  Then the fault
paths: a rank that raises, dies or hangs.  Tolerance: zero."""

import os
import re
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from hexl_fpga_tpu.ops import word64 as ref_w
from hexl_fpga_tpu.parallel import sharded as ref_sharded
from hexl_fpga_tpu_torch.ops import golden, nt
from hexl_fpga_tpu_torch.parallel import mesh as mesh_mod, rank_ops
from hexl_fpga_tpu_torch.parallel.mesh import RankError, run_ranks, spawn_ranks
from hexl_fpga_tpu_torch.utils import vectors

TESTDATA = os.path.join(os.path.dirname(__file__), "testdata")
CPU = "cpu"
N = 1024
SPAWN_TIMEOUT_S = 120  # a positive spawn that hangs fails here, not at the suite's limit


def child_pids():
    kids = set()
    for tid in os.listdir(f"/proc/{os.getpid()}/task"):
        with open(f"/proc/{os.getpid()}/task/{tid}/children") as f:
            kids.update(int(p) for p in f.read().split())
    return kids


def groups(P):
    """The world's groups at P ranks: (prefix, axes, maker, spec)."""
    q = int(nt.generate_primes(1, 45, N)[0])
    rng = np.random.default_rng(P)
    a = rng.integers(0, q, size=(2 * P, N), dtype=np.uint64)
    vec = vectors.load_json(os.path.join(TESTDATA, "1024_2_3_3_2_0.json"))
    ks = {"n": vec.coeff_count, "L": vec.decomp_modulus_size, "K": vec.key_modulus_size,
          "moduli": list(vec.moduli), "keys": vec.key_vectors,
          "msf": vec.modswitch_factors, "rs": vec.input[None],
          "ts": vec.t_target_iter_ptr[None]}
    coll = {"dp": 2, "mp": 2} if P == 4 else {"mp": 2}
    return q, a, vec, [
        ("coll", coll, rank_ops.collectives, {"k": 100}),
        ("dp", {"dp": P}, rank_ops.dp_ntt, {"n": N, "q": q, "x": a}),
        ("sp", {"sp": P}, rank_ops.sp_pair,
         {"n": N, "q": q, "x": a, "want_f": golden.fwd_ntt(a, q)}),
        ("mp", {"mp": P}, rank_ops.keyswitch, ks),
    ]


def same(got, want):
    """Equal, array by array, through tuples, lists and dicts."""
    if isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            same(g, w)
    else:
        assert got == want


def jax_dp_ntt(a, q, P):
    devs = jax.devices()
    assert len(devs) >= 8, "conftest must provide 8 virtual CPU devices"
    fn = ref_sharded.batch_sharded_fwd_ntt(JaxMesh(np.array(devs[:P]), ("dp",)), "dp", N, q)
    lo, hi = ref_w.to_pair_np(a)
    olo, ohi = fn(jnp.asarray(lo), jnp.asarray(hi))
    return ref_w.from_pair_np(np.asarray(olo), np.asarray(ohi))


@pytest.mark.parametrize("P", [2, 4])
def test_spawned_ranks_equal_threaded_ranks(P):
    """One spawn of P processes runs every group; each group's outputs equal
    the threaded run's rank by rank, each process counted as one."""
    q, a, vec, gs = groups(P)
    before = child_pids()
    per_rank = spawn_ranks(rank_ops.counted_groups, {"world": P}, device=CPU,
                           timeout_s=SPAWN_TIMEOUT_S, args=(gs,))
    assert not child_pids() - before, "a rank outlived spawn_ranks"
    assert len(per_rank) == P
    outs = {}
    for gi, (prefix, axes, maker, spec) in enumerate(gs):
        spawned = rank_ops.summarize([r[gi] for r in per_rank])
        threaded = rank_ops.summarize(run_ranks(
            lambda m, b=maker, s=spec: rank_ops.counted(m, b, s), axes, device=CPU))
        assert spawned.keys() == threaded.keys()
        for name in spawned:
            (s_outs, s_sum), (t_outs, t_sum) = spawned[name], threaded[name]
            same(s_outs, t_outs)
            assert s_sum["processes"] == P and t_sum["processes"] == 1
            assert s_sum["collectives_per_rank"] == t_sum["collectives_per_rank"]
            assert s_sum["wire_bytes"] == t_sum["wire_bytes"]
            outs[prefix, name] = s_outs
    # the coordinates are row-major; psum, all_gather, ppermute per axis
    coll = outs["coll", "collectives"]
    if P == 4:  # ranks (dp, mp): 0 (0,0), 1 (0,1), 2 (1,0), 3 (1,1); values rank + 1
        assert [c[0] for c in coll] == [{"dp": d, "mp": k} for d in (0, 1) for k in (0, 1)]
        assert [[int(p[0]) for p in c[1]] for c in coll] == [
            [4, 3], [6, 3], [4, 7], [6, 7]]
        assert [c[3][1].tolist() for c in coll] == [[0, 0], [1, 100], [0, 0], [3, 100]]
    else:
        assert [c[0] for c in coll] == [{"mp": 0}, {"mp": 1}]
        assert [c[1][0].tolist() for c in coll] == [[3, 200], [3, 200]]
        assert [c[2][0][:, 0].tolist() for c in coll] == [[1, 2], [1, 2]]
        assert [c[3][0].tolist() for c in coll] == [[0, 0], [1, 100]]
    # the dp NTT, the sp pair and the KeySwitch against their oracles
    dp = np.concatenate(outs["dp", "batch_sharded_fwd_ntt"])
    np.testing.assert_array_equal(dp, golden.fwd_ntt(a, q))
    if P == 4:
        np.testing.assert_array_equal(dp, jax_dp_ntt(a, q, P))
    np.testing.assert_array_equal(np.concatenate(outs["sp", "dist_fwd_ntt"], 1),
                                  golden.fwd_ntt(a, q))
    np.testing.assert_array_equal(np.concatenate(outs["sp", "dist_inv_ntt"], 1), a)
    for o in outs["mp", "run"]:
        np.testing.assert_array_equal(o[0], vec.expected_output)


@pytest.mark.parametrize("fault", ["raises", "dies"])
def test_a_rank_that_fails_fails_the_launch(fault):
    """A rank that raises (its traceback comes back) or dies (its exit
    code); rank 0 sits in a barrier until the launcher kills it."""
    before = child_pids()
    t0 = time.monotonic()
    body, args = ((rank_ops.fail_on, (1, "rank 1 fails on purpose")) if fault == "raises"
                  else (rank_ops.die_on, (1, 3)))
    with pytest.raises(RankError, match="rank 1 of 2 failed") as err:
        spawn_ranks(body, {"mp": 2}, device=CPU, timeout_s=SPAWN_TIMEOUT_S, args=args)
    assert time.monotonic() - t0 < SPAWN_TIMEOUT_S / 2
    text = str(err.value)
    if fault == "raises":
        assert "Traceback" in text and "ValueError: rank 1 fails on purpose" in text
        assert "in fail_on" in text
    else:
        assert "sent no result (exit code 3)" in text
    assert err.value.rank == 1
    assert not child_pids() - before


def test_a_rank_that_hangs_is_killed_at_the_timeout():
    before = child_pids()
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match=re.escape("ranks [0") + r"(, 1)?\] of 2"):
        spawn_ranks(rank_ops.stall, {"mp": 2}, device=CPU, timeout_s=6, args=(0, 600))
    assert time.monotonic() - t0 < 30
    assert not child_pids() - before


def test_spawn_ranks_refuses_what_a_rank_cannot_find():
    with pytest.raises(ValueError, match="module-level"):
        spawn_ranks(lambda m: m.rank, {"mp": 2}, device=CPU)

    def nested(m):
        return m.rank

    with pytest.raises(ValueError, match="module-level"):
        spawn_ranks(nested, {"mp": 2}, device=CPU)


def test_spawn_ranks_and_from_env_default_to_the_card(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    before = child_pids()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spawn_ranks(rank_ops.stall, {"mp": 2}, args=(0, 0))
    assert not child_pids() - before  # raised before starting anything
    for k, v in dict(RANK="0", WORLD_SIZE="2", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT="1").items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh_mod.Mesh.from_env({"mp": 2})


def test_from_env_checks_the_launcher_contract(monkeypatch):
    for k in mesh_mod.LAUNCH_ENV:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="not set"):
        mesh_mod.Mesh.from_env({"mp": 2}, CPU)
    for k, v in dict(RANK="0", WORLD_SIZE="4", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT="1").items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="WORLD_SIZE 4 is not the 2 ranks"):
        mesh_mod.Mesh.from_env({"mp": 2}, CPU)
    with pytest.raises(ValueError, match="WORLD_SIZE 4 is not the 6 ranks"):
        mesh_mod.Mesh.from_env({"dp": 2, "mp": 3}, CPU)
