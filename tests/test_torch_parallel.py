"""The port's multi-device layer on the CPU: ranks as threads, each with its
own gloo groups (`parallel.mesh.run_ranks`), the kernels' plain versions.

The dp NTT and the sp pair are held against the reference's functions on
the JAX 8-device CPU mesh (tests/conftest.py) and golden; ShardedKeySwitch,
whose reference takes half a minute to compile here, against the frozen
vectors and the reference's golden model, as tests/test_parallel.py holds
the reference, and against the port's single-card context.  Tolerance:
zero."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from hexl_fpga_tpu.ops import golden as ref_golden, word64 as ref_w
from hexl_fpga_tpu.parallel import sharded as ref_sharded
from hexl_fpga_tpu_torch.ops import (
    galois_cuda, golden, keyswitch_cuda, nt, ntt_cuda, twiddles, word64 as w,
)
from hexl_fpga_tpu_torch.parallel import mesh as mesh_mod, sharded
from hexl_fpga_tpu_torch.parallel.mesh import run_ranks
from hexl_fpga_tpu_torch.utils import keycache, vectors

TESTDATA = os.path.join(os.path.dirname(__file__), "testdata")
CPU = "cpu"


def jax_mesh(P, name):
    devs = jax.devices()
    assert len(devs) >= 8, "conftest must provide 8 virtual CPU devices"
    return JaxMesh(np.array(devs[:P]), (name,))


def run_jax(fn, a):
    lo, hi = ref_w.to_pair_np(a)
    olo, ohi = fn(jnp.asarray(lo), jnp.asarray(hi))
    return ref_w.from_pair_np(np.asarray(olo), np.asarray(ohi))


def blocks(a, P, p):
    S = a.shape[-1] // P
    return np.ascontiguousarray(a[..., p * S:(p + 1) * S])


def rand(q, shape, seed):
    return np.random.default_rng(seed).integers(0, q, size=shape, dtype=np.uint64)


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------


def test_mesh_coordinates_and_collectives():
    """Row-major coordinates (as a jax Mesh over devices.reshape), and
    psum / all_gather / ppermute over each axis group alone."""

    def body(m):
        x = torch.tensor([m.rank + 1, 100], dtype=torch.int64)
        return (m.coords, m.psum(x, "mp").tolist(), m.psum(x, "dp").tolist(),
                m.all_gather(x, "mp")[:, 0].tolist(),
                m.ppermute(x, "mp", [(0, 1)]).tolist(),  # rank 0 sends to 1
                m.stats)

    out = run_ranks(body, {"dp": 2, "mp": 2}, device=CPU)
    assert [o[0] for o in out] == [{"dp": d, "mp": k} for d in (0, 1) for k in (0, 1)]
    # ranks (dp, mp): 0 (0,0), 1 (0,1), 2 (1,0), 3 (1,1); values rank + 1
    assert [o[1] for o in out] == [[3, 200], [3, 200], [7, 200], [7, 200]]
    assert [o[2] for o in out] == [[4, 200], [6, 200], [4, 200], [6, 200]]
    assert [o[3] for o in out] == [[1, 2], [1, 2], [3, 4], [3, 4]]
    assert [o[4] for o in out] == [[0, 0], [1, 100], [0, 0], [3, 100]]
    for o in out:
        assert o[5]["calls"] == {"psum": 2, "all_gather": 1, "ppermute": 1}
        assert o[5]["host_staged_bytes"] == 0  # CPU tensors go to gloo as they are


def test_run_ranks_raises_a_rank_error_and_joins_every_thread():
    def body(m):
        if m.rank == 1:
            raise ValueError("rank 1 fails")
        return m.rank

    with pytest.raises(ValueError, match="rank 1 fails"):
        run_ranks(body, {"mp": 2}, device=CPU)
    import threading

    assert not [t for t in threading.enumerate() if t.name.startswith("rank")]


def test_collectives_stay_exact_under_thread_switching():
    """Sixteen ranks, more threads than cores, switching every microsecond:
    30 psums and all_gathers each, every sum and every gathered row exact,
    every rank's counters its own."""
    import sys

    def body(m):
        out = []
        for i in range(30):
            x = torch.full((5,), (m.rank + 1) * 1000 + i, dtype=torch.int64)
            out.append((m.psum(x, "x")[0].item(), m.all_gather(x, "x")[:, 0].tolist()))
        return out, m.stats["calls"]

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        res = run_ranks(body, {"x": 16}, device=CPU, timeout_s=60)
    finally:
        sys.setswitchinterval(old)
    for out, calls in res:
        assert calls == {"psum": 30, "all_gather": 30}
        for i, (total, rows) in enumerate(out):
            assert rows == [(r + 1) * 1000 + i for r in range(16)]
            assert total == sum(rows)


def test_mesh_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh_mod.Mesh(torch.distributed.HashStore(), 0, {"mp": 1})


# ---------------------------------------------------------------------------
# 'dp' and 'sp' transforms
# ---------------------------------------------------------------------------


def test_batch_sharded_fwd_ntt_matches_reference_mesh():
    n, P = 1024, 4
    q = int(nt.generate_primes(1, 45, n)[0])
    a = rand(q, (8, n), 0)
    want = run_jax(ref_sharded.batch_sharded_fwd_ntt(jax_mesh(P, "dp"), "dp", n, q), a)
    np.testing.assert_array_equal(want, golden.fwd_ntt(a, q))

    def body(m):
        rows = a[2 * m.rank:2 * m.rank + 2]
        got = [w.to_u64_np(f(m, "dp", n, q)(w.from_u64_np(rows, CPU)))
               for f in (sharded.batch_sharded_fwd_ntt,
                         sharded.batch_sharded_fwd_ntt_mxu)]
        assert np.array_equal(got[0], got[1])
        return got[0]

    np.testing.assert_array_equal(np.concatenate(run_ranks(body, {"dp": P}, device=CPU)),
                                  want)


@pytest.mark.parametrize("n,P", [(1024, 4), (2048, 2)])
def test_dist_ntt_pair_matches_reference_mesh(n, P):
    """Forward and inverse against the reference's binary exchange on the JAX
    CPU mesh and golden; the round trip; INTT -> NTT chained on the rank
    tensors with no reshard."""
    q = int(nt.generate_primes(1, 45, n)[0])
    a = rand(q, (3, n), n + P)
    jm = jax_mesh(P, "sp")
    want_f = run_jax(ref_sharded.dist_fwd_ntt(jm, "sp", n, q), a)
    want_i = run_jax(ref_sharded.dist_inv_ntt(jm, "sp", n, q), want_f)
    np.testing.assert_array_equal(want_f, golden.fwd_ntt(a, q))
    np.testing.assert_array_equal(want_i, a)

    def body(m):
        p = m.axis_index("sp")
        fwd, inv = sharded.dist_fwd_ntt(m, "sp", n, q), sharded.dist_inv_ntt(m, "sp", n, q)
        f = fwd(w.from_u64_np(blocks(a, P, p), CPU))
        i = inv(w.from_u64_np(blocks(want_f, P, p), CPU))
        chained = fwd(inv(f))  # rank tensors in, rank tensors out
        return [w.to_u64_np(x) for x in (f, i, chained)]

    out = run_ranks(body, {"sp": P}, device=CPU)
    f, i, chained = (np.concatenate([o[k] for o in out], axis=1) for k in range(3))
    np.testing.assert_array_equal(f, want_f)
    np.testing.assert_array_equal(i, want_i)
    np.testing.assert_array_equal(chained, want_f)


@pytest.mark.parametrize("P,chunks", [(2, 1), (4, 3), (8, 4)])
def test_dist_ntt_mxu_names_partition_the_batch(P, chunks):
    """The reference's TPU-tier names run the same kernel-backed pair; chunks
    only partition the batch.  Input any u64, as the kernels take it."""
    n = 1024
    q = int(nt.generate_primes(1, 51, n)[0])
    a = np.random.default_rng(P).integers(0, 1 << 64, size=(5, n), dtype=np.uint64)

    def body(m):
        p = m.axis_index("sp")
        f = sharded.dist_fwd_ntt_mxu(m, "sp", n, q, chunks)(w.from_u64_np(blocks(a, P, p), CPU))
        return w.to_u64_np(f), w.to_u64_np(sharded.dist_inv_ntt_mxu(m, "sp", n, q, chunks)(f))

    out = run_ranks(body, {"sp": P}, device=CPU)
    f = np.concatenate([o[0] for o in out], axis=1)
    np.testing.assert_array_equal(f, golden.fwd_ntt(a % np.uint64(q), q))
    np.testing.assert_array_equal(np.concatenate([o[1] for o in out], axis=1),
                                  a % np.uint64(q))


@pytest.mark.parametrize("n,P", [(64, 2), (1024, 4), (2048, 8)])
def test_block_tables_are_the_global_stages_of_a_block(n, P):
    """A rank's caller tables make ntt_fwd_plain / ntt_inv_plain run exactly
    the global stages inside its block: forward, the split plain version's
    piece p of P (its stages read the global table at (P + p) * m);
    inverse, the global inverse stages of m >= P groups on the whole row,
    then block p (the block's last stage unscaled: inv_n = 1)."""
    q = int(nt.generate_primes(1, 50, n)[0])
    S = n // P
    full = ntt_cuda.modulus_tables(n, q, device=CPU)
    x = w.from_u64_np(rand(q, (3, n), n), CPU)
    for p in range(P):
        piece = x[:, p * S:(p + 1) * S].contiguous()
        ft = ntt_cuda.caller_fwd_tables(S, q, *sharded.fwd_block_tables(n, q, P, p),
                                        device=CPU)
        want = ntt_cuda._reduce4(ntt_cuda._fwd_stages_plain(piece, full, P, p), q)
        assert torch.equal(ntt_cuda.ntt_fwd_plain(piece, ft), want)
        tab, pre, last = sharded.inv_block_tables(n, q, P, p)
        it = ntt_cuda.caller_inv_tables(S, q, tab, pre, 1, last, device=CPU)
        y, m = x, n >> 1
        while m >= P:
            y = ntt_cuda._inv_stage_plain(y, full, m, n - 2 * m + 1)
            m >>= 1
        want = w.barrett_canonical(y[:, p * S:(p + 1) * S], q, full.q_barr)
        assert torch.equal(ntt_cuda.ntt_inv_plain(piece, it), want)


# ---------------------------------------------------------------------------
# ShardedKeySwitch
# ---------------------------------------------------------------------------


AXES = {"1x2": {"mp": 2}, "2x2": {"dp": 2, "mp": 2}, "1x4": {"mp": 4}}


def sharded_run(vec, axes, B, rs, ts, plain_modulus=None, keys=None):
    n, L, K = vec.coeff_count, vec.decomp_modulus_size, vec.key_modulus_size
    keys = vec.key_vectors if keys is None else keys

    def body(m):
        ks = sharded.ShardedKeySwitch(m, "mp", "dp" if "dp" in axes else None,
                                      n, L, K, vec.moduli, plain_modulus)
        return ks.run(rs, ts, keys, vec.modswitch_factors)

    out = run_ranks(body, axes, device=CPU)
    for o in out[1:]:
        np.testing.assert_array_equal(o, out[0])  # the same on every rank
    assert out[0].shape == (B, 2 * L * n)
    return out[0]


@pytest.mark.parametrize("name,mesh", [
    ("1024_2_3_3_2_0", "1x2"), ("1024_2_3_3_2_1", "2x2"),
    ("1024_5_7_6_2_0", "1x2"), ("1024_5_7_6_2_0", "2x2"), ("1024_5_7_6_2_0", "1x4"),
    ("2048_3_4_4_2_0", "1x4"),
])
def test_sharded_keyswitch_matches_frozen_vector(name, mesh):
    vec = vectors.load_json(os.path.join(TESTDATA, name + ".json"))
    B = 4
    got = sharded_run(vec, AXES[mesh], B, np.stack([vec.input] * B),
                      np.stack([vec.t_target_iter_ptr] * B))
    for b in range(B):
        np.testing.assert_array_equal(got[b], vec.expected_output)


def random_ops(vec, B, seed):
    rng = np.random.default_rng(seed)
    L, n = vec.decomp_modulus_size, vec.coeff_count
    ts = np.stack([np.concatenate([rng.integers(0, vec.moduli[j], size=n, dtype=np.uint64)
                                   for j in range(L)]) for _ in range(B)])
    rs = np.stack([np.concatenate([rng.integers(0, vec.moduli[j % L], size=n, dtype=np.uint64)
                                   for j in range(2 * L)]) for _ in range(B)])
    return rs, ts


def single_card(vec, plain_modulus=None):
    n, L, K = vec.coeff_count, vec.decomp_modulus_size, vec.key_modulus_size
    return keyswitch_cuda.KeySwitchContext(n, L, K, L + 1, 2, vec.moduli, None,
                                           device=CPU, plain_modulus=plain_modulus)


@pytest.mark.parametrize("mesh", ["2x2", "1x4"])
def test_sharded_keyswitch_matches_golden_and_single_card(mesh):
    """Operands drawn from a seed: every op equal to the single-card
    context's batch, two to the reference's golden model."""
    vec = vectors.make_keyswitch_vector(64, 3, 4, seed=7, modulus_bits=40)
    n, L, K = 64, 3, 4
    B = 4
    rs, ts = random_ops(vec, B, 1)
    got = sharded_run(vec, AXES[mesh], B, rs, ts)
    np.testing.assert_array_equal(
        got, single_card(vec).run_batch(rs, ts, vec.key_vectors, vec.modswitch_factors))
    for b in (0, B - 1):
        np.testing.assert_array_equal(got[b], ref_golden.keyswitch(
            rs[b], ts[b], n, L, K, L + 1, 2, vec.moduli, vec.key_vectors,
            vec.modswitch_factors, None))


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_sharded_keyswitch_bgv(mesh):
    """plain_modulus: sigma from the broadcast e on every rank, each owned
    tail against the frozen BGV vector, the reference's golden model and the
    single-card BGV context."""
    t = 257
    vec = vectors.make_keyswitch_vector(64, 3, 4, seed=7, modulus_bits=40,
                                        plain_modulus=t)
    B = 2
    rs, ts = np.stack([vec.input] * B), np.stack([vec.t_target_iter_ptr] * B)
    got = sharded_run(vec, AXES[mesh], B, rs, ts, plain_modulus=t)
    for b in range(B):
        np.testing.assert_array_equal(got[b], vec.expected_output)
    rs2, ts2 = random_ops(vec, B, 5)
    got2 = sharded_run(vec, AXES[mesh], B, rs2, ts2, plain_modulus=t)
    np.testing.assert_array_equal(got2, single_card(vec, t).run_batch(
        rs2, ts2, vec.key_vectors, vec.modswitch_factors))
    np.testing.assert_array_equal(got2[0], ref_golden.keyswitch(
        rs2[0], ts2[0], 64, 3, 4, 4, 2, vec.moduli, vec.key_vectors,
        vec.modswitch_factors, None, plain_modulus=t))


@pytest.mark.parametrize("mesh", ["1x2", "2x2", "1x4"])
def test_sharded_hoisted_keyswitch(mesh):
    """hoist + run_hoisted: the plain apply equals the frozen vector; the
    Galois apply equals the single-card run_hoisted and the permuted-keys
    identity sigma(run(keys permuted by sigma^-1))."""
    vec = vectors.load_json(os.path.join(TESTDATA, "1024_2_3_3_2_0.json"))
    n, L, K = vec.coeff_count, vec.decomp_modulus_size, vec.key_modulus_size
    B, g = 2, pow(5, 3, 2 * n)
    axes = AXES[mesh]
    rs, ts = np.stack([vec.input] * B), np.stack([vec.t_target_iter_ptr] * B)

    def body(m):
        ks = sharded.ShardedKeySwitch(m, "mp", "dp" if "dp" in axes else None,
                                      n, L, K, vec.moduli)
        dec = ks.hoist(ts)
        owned = [j for j in ks.owned if j >= 0]
        assert dec.data.shape == (len(owned), L * (B // axes.get("dp", 1)), n)
        return (ks.run_hoisted(dec, rs, vec.key_vectors, vec.modswitch_factors),
                ks.run_hoisted(dec, rs, vec.key_vectors, vec.modswitch_factors,
                               galois=g))

    out = run_ranks(body, axes, device=CPU)
    plain, rot = out[0]
    for o in out[1:]:
        np.testing.assert_array_equal(o[0], plain)
        np.testing.assert_array_equal(o[1], rot)
    for b in range(B):
        np.testing.assert_array_equal(plain[b], vec.expected_output)
    ctx = single_card(vec)
    want = ctx.run_hoisted(ctx.hoist(ts), rs, vec.key_vectors, vec.modswitch_factors,
                           galois=g).to_host()
    np.testing.assert_array_equal(rot, want)
    sigma = galois_cuda.ntt_galois_sigma(n, g)
    inv = np.empty_like(sigma)
    inv[sigma] = np.arange(n)
    keys_perm = [np.ascontiguousarray(np.asarray(kv, np.uint64).reshape(2, K, n)[..., inv])
                 .reshape(-1) for kv in vec.key_vectors]
    full = sharded_run(vec, axes, B, rs, ts, keys=keys_perm)
    np.testing.assert_array_equal(rot, full.reshape(B, 2, L, n)[..., sigma].reshape(B, -1))


def test_comm_report_slots_and_one_key_upload_per_key_set():
    """comm_report equals the reference object's (constructing it compiles
    nothing); the slot layout is the reference's; each rank uploads a key
    set once."""
    vec = vectors.make_keyswitch_vector(64, 3, 4, seed=3, modulus_bits=40)
    ref = ref_sharded.ShardedKeySwitch(jax_mesh(4, "mp"), "mp", None, 64, 3, 4,
                                       vec.moduli)
    B = 2
    rs, ts = random_ops(vec, B, 2)
    before = keycache.UPLOADS["key_sets"]

    def body(m):
        ks = sharded.ShardedKeySwitch(m, "mp", None, 64, 3, 4, vec.moduli)
        first = ks.run(rs, ts, vec.key_vectors, vec.modswitch_factors)
        again = ks.run(rs, ts, vec.key_vectors, vec.modswitch_factors)
        assert np.array_equal(first, again)
        k1, k2 = ks._staged_keys(vec.key_vectors), ks._staged_keys(vec.key_vectors)
        assert k1[0] is k2[0] and k1[1] is k2[1]
        assert ks.prepare_msf4(vec.modswitch_factors).shape == (4, 2)
        return ks.comm_report(batch=B), ks.engines, ks.per_shard, ks.owned

    out = run_ranks(body, {"mp": 4}, device=CPU)
    assert keycache.UPLOADS["key_sets"] - before == 4  # one a rank
    assert out[0][0] == ref.comm_report(batch=B)
    assert out[0][1] == ref.engines and out[0][2] == ref.per_shard
    assert [o[3] for o in out] == [ref.engines[p:p + 1] for p in range(4)]
    assert out[0][0]["e_broadcast_psum_bytes"] == B * 2 * 64 * 8


def test_sharded_keyswitch_counts_its_collectives():
    """Per run over 'mp' only: one psum (e) and one all_gather (the owned
    slices); with 'dp' one more all_gather (the batch)."""
    vec = vectors.make_keyswitch_vector(64, 2, 3, seed=4, modulus_bits=40)
    rs, ts = random_ops(vec, 2, 3)

    def body(m):
        ks = sharded.ShardedKeySwitch(m, "mp", "dp", 64, 2, 3, vec.moduli)
        ks.run(rs, ts, vec.key_vectors, vec.modswitch_factors)
        return dict(m.stats["calls"])

    assert run_ranks(body, {"dp": 2, "mp": 2}, device=CPU) == [
        {"psum": 1, "all_gather": 2}] * 4
