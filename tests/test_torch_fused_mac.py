"""The fused transform + key-MAC engine (`ntt_cuda.ntt_fwd_mac`): its plain
version on the CPU vs the reference's Pallas kernel (`raw_fwd_mac_call`, in
interpret mode) and vs sums of golden products, on the kernel's split of a
row into C pieces too; and the kernel's launch shape (`mac_split`).
Tolerance: zero, after reduction mod q (both sides are lazy
representatives)."""

import functools

import numpy as np
import pytest
import torch

from hexl_fpga_tpu.ops import ntt_mxu_pallas, word64 as jw
from hexl_fpga_tpu_torch.ops import golden, nt, ntt_cuda, twiddles, word64 as w

N, L, COMP, B = 1024, 2, 2, 2


def make_case(K, seed, bits=45, any_u64=False, n=N, L=L, B=B):
    """(moduli, data (L*B, n), keys (L, comp, K, n), precons) as u64 numpy."""
    rng = np.random.default_rng(seed)
    moduli = [int(q) for q in nt.generate_primes(K, bits, n)]
    if any_u64:  # odd values over the whole 64-bit range
        data = rng.integers(0, 1 << 63, size=(L * B, n), dtype=np.uint64)
        data = data * np.uint64(2) + np.uint64(1)
    else:  # what the reference's limb pipeline takes: below 2^53
        data = rng.integers(0, 1 << 52, size=(L * B, n), dtype=np.uint64)
    keys = np.stack([rng.integers(0, q, size=(L, COMP, n), dtype=np.uint64)
                     for q in moduli], axis=2)
    kp = np.stack([w.precon64_np(keys[:, :, j], q) for j, q in enumerate(moduli)],
                  axis=2)
    return moduli, data, keys, kp


def golden_sum(data, keys, j, q, skip_i, L=L, B=B):
    """sum over i != skip_i of NTT_q(data_i mod q) * key[i, k, j] mod q, by the
    golden transform and Python-int products."""
    n = data.shape[1]
    t = twiddles.ntt_tables(n, q)
    val = golden.fwd_ntt(data % np.uint64(q), q, t).reshape(L, B, n)
    out = np.zeros((COMP, B, n), dtype=object)
    for i in range(L):
        if i == skip_i:
            continue
        for k in range(COMP):
            out[k] = (out[k] + val[i].astype(object) * keys[i, k, j].astype(object)) % q
    return out.astype(np.uint64)


def run_plain(data, keys, kp, j, q, skip_i):
    tabs = ntt_cuda.modulus_tables(data.shape[1], q, device="cpu")
    out = ntt_cuda.ntt_fwd_mac(w.from_u64_np(data), w.from_u64_np(keys),
                               w.from_u64_np(kp), j, tabs, skip_i)
    return w.to_u64_np(out)


@pytest.mark.parametrize("skip_i", [None, 0, L - 1])
def test_plain_matches_pallas_kernel_and_golden(skip_i):
    K = 3
    moduli, data, keys, kp = make_case(K, seed=31)
    j = K - 1 if skip_i is None else skip_i
    q = moduli[j]
    got = run_plain(data, keys, kp, j, q, skip_i)
    assert got.shape == (COMP, B, N)
    assert int(got.max()) < 2 * L * q
    call = ntt_mxu_pallas.raw_fwd_mac_call(
        N, q, L, COMP, tile_p=2, skip_i=skip_i, interpret=True, data_bits=53)
    col = lambda a: jw.to_pair_np(np.ascontiguousarray(a[:, :, j]))
    ref_lo, ref_hi = call(*jw.to_pair_np(data), *col(keys), *col(kp))
    ref = jw.from_pair_np(np.asarray(ref_lo), np.asarray(ref_hi))
    np.testing.assert_array_equal(got % np.uint64(q), ref % np.uint64(q))
    np.testing.assert_array_equal(got % np.uint64(q),
                                  golden_sum(data, keys, j, q, skip_i))


@pytest.mark.parametrize("K,j,skip_i,any_u64", [
    (4, 3, None, False),  # K > L + 1: the special engine reads column K - 1
    (4, 1, 1, False),
    (3, 2, None, True),   # any 64-bit representative is reduced on load
    (3, 0, 0, True),
])
def test_key_column_and_any_u64_input(K, j, skip_i, any_u64):
    moduli, data, keys, kp = make_case(K, seed=32 + K, any_u64=any_u64)
    q = moduli[j]
    got = run_plain(data, keys, kp, j, q, skip_i)
    assert int(got.max()) < 2 * L * q
    np.testing.assert_array_equal(got % np.uint64(q),
                                  golden_sum(data, keys, j, q, skip_i))


def test_three_limbs_middle_skip_is_the_sum_without_that_limb():
    moduli, data, keys, kp = make_case(4, seed=40, L=3, B=1)
    q = moduli[1]
    full = run_plain(data, keys, kp, 1, q, None)
    part = run_plain(data, keys, kp, 1, q, 1)
    tabs = ntt_cuda.modulus_tables(N, q, device="cpu")
    mid = ntt_cuda.ntt_fwd_mac_plain(
        w.from_u64_np(data[1:2]), w.from_u64_np(keys[1:2]),
        w.from_u64_np(kp[1:2]), 1, tabs)
    # wrapping sums of the same terms: equal as bits, not only mod q
    np.testing.assert_array_equal(full, part + w.to_u64_np(mid))
    np.testing.assert_array_equal(
        part % np.uint64(q), golden_sum(data, keys, 1, q, 1, L=3, B=1))


def test_wrapper_refuses_what_the_kernel_does_not_take():
    moduli, data, keys, kp = make_case(3, seed=41)
    tabs = ntt_cuda.modulus_tables(N, moduli[0], device="cpu")
    d, k, p = w.from_u64_np(data), w.from_u64_np(keys), w.from_u64_np(kp)
    with pytest.raises(ValueError, match="skip_i needs L >= 2"):
        ntt_cuda.ntt_fwd_mac(d[:B], k[:1].contiguous(), p[:1].contiguous(), 0, tabs, 0)
    with pytest.raises(ValueError, match="skip_i 2 outside"):
        ntt_cuda.ntt_fwd_mac(d, k, p, 0, tabs, 2)
    with pytest.raises(ValueError, match="key column 3"):
        ntt_cuda.ntt_fwd_mac(d, k, p, 3, tabs)
    with pytest.raises(ValueError, match="do not split"):
        ntt_cuda.ntt_fwd_mac(d[:3], k, p, 0, tabs)
    with pytest.raises(ValueError, match="share one"):
        ntt_cuda.ntt_fwd_mac(d, k, p[:, :1], 0, tabs)
    with pytest.raises(TypeError, match="contiguous int64"):
        ntt_cuda.ntt_fwd_mac(d, k.transpose(0, 1), p, 0, tabs)  # same shape, strided
    # a CPU tensor took the plain version: nothing was launched
    assert ntt_cuda.LAUNCHES["ntt_fwd_mac"] == 0


# -- the kernel's split: C pieces a row, the limbs shared by a cluster --------

SPLIT_L = 3


@functools.lru_cache(maxsize=None)
def split_case():
    """(moduli, data, keys, precons) at L = 3, so that a middle limb exists."""
    return make_case(3, seed=50, L=SPLIT_L)


@functools.lru_cache(maxsize=None)
def pallas_split_ref(skip_i):
    """The Pallas kernel's lazy sums (interpret mode) for the split case."""
    moduli, data, keys, kp = split_case()
    j = 2 if skip_i is None else skip_i
    call = ntt_mxu_pallas.raw_fwd_mac_call(
        N, moduli[j], SPLIT_L, COMP, tile_p=2, skip_i=skip_i, interpret=True,
        data_bits=53)
    col = lambda a: jw.to_pair_np(np.ascontiguousarray(a[:, :, j]))
    lo, hi = call(*jw.to_pair_np(data), *col(keys), *col(kp))
    return jw.from_pair_np(np.asarray(lo), np.asarray(hi))


@pytest.mark.parametrize("skip_i,parts", [(s, p) for s in (None, 0, 1, 2)
                                          for p in (1, 2, 4)])
def test_split_plain_matches_pallas_kernel_and_golden(skip_i, parts):
    """ntt_fwd_mac_plain on C-piece rows (the kernel's transform schedule)
    against the reference's kernel and golden sums, with no limb, the first,
    a middle or the last skipped."""
    moduli, data, keys, kp = split_case()
    j = 2 if skip_i is None else skip_i
    q = moduli[j]
    tabs = ntt_cuda.modulus_tables(N, q, device="cpu")
    got = w.to_u64_np(ntt_cuda.ntt_fwd_mac_plain(
        w.from_u64_np(data), w.from_u64_np(keys), w.from_u64_np(kp), j, tabs,
        skip_i, parts))
    assert int(got.max()) < 2 * SPLIT_L * q
    ref = pallas_split_ref(skip_i)
    np.testing.assert_array_equal(got % np.uint64(q), ref % np.uint64(q))
    np.testing.assert_array_equal(got % np.uint64(q),
                                  golden_sum(data, keys, j, q, skip_i, L=SPLIT_L))
    # the bits do not depend on the split: equal to the one-block schedule
    np.testing.assert_array_equal(got, run_plain(data, keys, kp, j, q, skip_i))


def test_mac_launch_shape_at_the_fused_body():
    """The fused-MAC body's engines (32 rows over 6 limbs, or 5 with the
    identity limb skipped) take pairs of blocks at two pieces a row: 128
    blocks, one wave of the model's one block an SM; one limb takes no
    cluster; a piece must leave room for the sums."""
    assert ntt_cuda.mac_split(32, 6, 16384) == (2, 2)
    assert ntt_cuda.mac_split(32, 5, 16384) == (2, 2)
    assert ntt_cuda.mac_split(32, 1, 16384)[1] == 1
    assert ntt_cuda.split_candidates(16384, "ntt_fwd_mac") == [2, 4]
    assert ntt_cuda.mac_chunk(16384, 1, 2) == 0  # 136 KB piece, 128 KB a component
    assert ntt_cuda.mac_chunk(16384, 2, 2) == 2
    moduli, data, keys, kp = make_case(3, seed=51)
    d, k, p = w.from_u64_np(data), w.from_u64_np(keys), w.from_u64_np(kp)
    tabs = ntt_cuda.modulus_tables(N, moduli[0], device="cpu")
    with pytest.raises(ValueError, match="cluster"):
        ntt_cuda.ntt_fwd_mac(d, k, p, 0, tabs, 0, cluster=2)  # one limb left
    with pytest.raises(ValueError, match="parts"):
        ntt_cuda.ntt_fwd_mac(d, k, p, 0, tabs, parts=3)
    # a CPU tensor under a forced launch shape takes the plain version
    ntt_cuda.reset_launch_counts()
    assert torch.equal(ntt_cuda.ntt_fwd_mac(d, k, p, 0, tabs, None, 4, 2),
                       ntt_cuda.ntt_fwd_mac_plain(d, k, p, 0, tabs, None, 1))
    assert ntt_cuda.LAUNCHES["ntt_fwd_mac"] == 0
