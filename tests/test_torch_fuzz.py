"""utils/fuzz_card.py on the CPU: its grid (which widths exist at each n,
the reference fuzz's skip rule, the envelope's edges), its rehearsal with the
kernels' plain versions at n = 64 and 1024, and the envelope's edges against
the JAX package: KeySwitch at n = 1024 under the smallest-width moduli and
under the largest 52-bit ones, the dyadic product at 17, 52 and 60 bits
(which operands lie in MultMod's exact domain), a transform under the
largest 62-bit prime.  Tolerance: zero."""

import json

import numpy as np
import pytest

from hexl_fpga_tpu.ops import dyadic_jax, golden as jgolden, keyswitch_jax, nt as jnt
from hexl_fpga_tpu_torch.ops import dyadic_cuda, golden, keyswitch_cuda, nt, ntt_cuda
from hexl_fpga_tpu_torch.ops import twiddles, word64 as w
from hexl_fpga_tpu_torch.utils import fuzz_card, vectors

# the smallest width (>= 17 bits) that holds K primes q = 1 mod 2n, per
# (n, K) of the KeySwitch grid
SMALLEST = {(1024, 2): 17, (1024, 7): 18, (2048, 2): 17, (2048, 7): 18,
            (4096, 2): 17, (4096, 7): 20, (8192, 2): 17, (8192, 7): 21,
            (16384, 2): 20, (16384, 7): 23}


# -- the grid -------------------------------------------------------------------


@pytest.mark.parametrize("n", fuzz_card.TRANSFORM_N)
def test_width_primes_at_each_n(n):
    """A width w is tried where scripts/fuzz_hw.py's rule keeps its bits =
    w - 1 (it skips bits <= log2 n); its smallest prime is the JAX package's
    generate_primes(1, w - 1, n), its largest the last q = 1 mod 2n below
    2^w; every width of the grid exists at every n."""
    log2n = nt.log2_exact(n)
    for width in range(2, 64):
        assert fuzz_card.width_exists(n, width) == (not width - 1 <= log2n)
    for width in fuzz_card.TRANSFORM_WIDTHS:
        lo = fuzz_card.width_primes(1, width, n)[0]
        hi = fuzz_card.width_primes(1, width, n, top=True)[0]
        assert lo == jnt.generate_primes(1, width - 1, n)[0]
        for q in (lo, hi):
            assert q.bit_length() == width and q % (2 * n) == 1 and jnt.is_prime(q)
        above = range(hi + 2 * n, 1 << width, 2 * n)
        assert not any(jnt.is_prime(q) for q in above)
    assert fuzz_card.width_primes(1, log2n + 1, n) is None  # the skip rule


def test_keyswitch_edges_are_the_smallest_and_largest_widths():
    for (n, K), width in SMALLEST.items():
        assert fuzz_card.smallest_width(K, n) == width
        got = fuzz_card.width_primes(K, width, n)
        assert list(got) == jnt.generate_primes(K, width - 1, n)
        if width > fuzz_card.KS_MIN_WIDTH:  # one bit less holds fewer
            with pytest.raises(RuntimeError):
                jnt.generate_primes(K, width - 2, n)
        top = fuzz_card.width_primes(K, 52, n, top=True)
        assert all(q < 1 << 52 and q.bit_length() == 52 for q in top)
        assert all(1 << 16 <= q for q in got)  # inside api.KeySwitch's range


def test_grids():
    t, k, d = fuzz_card.grids(quick=False)
    per_width = len(fuzz_card.TRANSFORM_WIDTHS) + len(fuzz_card.TOP_WIDTHS)
    assert len(t) == len(fuzz_card.TRANSFORM_N) * per_width
    edges = len(fuzz_card.KS_N) * len(fuzz_card.KS_LK) * 2
    assert len(k) == edges + len(fuzz_card.FUZZ_HW_KEYSWITCH) + 1
    assert len(d) == (len(fuzz_card.DYADIC_N) * len(fuzz_card.DYADIC_M)
                      * len(fuzz_card.DYADIC_WIDTHS))
    assert [c for c in k if c.plain_modulus] == [k[-1]]
    tq, kq, dq = fuzz_card.grids(quick=True)
    assert set(tq) <= set(t) and set(dq) <= set(d)
    edges = lambda grid: {(c.n, c.L, c.K, c.moduli) for c in grid if "fuzz_hw" not in c.label}
    assert edges(kq) <= edges(k)
    assert sum(c.n == 16384 for c in kq) == 1  # one host-side golden at 16384


# -- the rehearsal ---------------------------------------------------------------


def small_grids():
    return (fuzz_card.transform_grid(sizes=(64, 1024), widths=(20, 62)),
            [fuzz_card.keyswitch_edge(1024, 1, 2, "smallest", seed=1)],
            fuzz_card.dyadic_grid(sizes=(64, 1024), ms=(1, 3), widths=(17, 60)))


def test_rehearsal_on_the_cpu_passes():
    lines = []
    out = fuzz_card.run("cpu", *small_grids(), seed=3, echo=lines.append)
    assert out.failures == []
    assert out.configs == len(lines) == 6 + 1 + 8
    assert all(line.split(": ")[1].startswith("OK") for line in lines)
    # no launch and no kernel comparison off the card
    assert out.launches == {} and out.kernels_vs_plain == {}
    assert out.edges["ntt_widths_by_n"] == {"64": [20, 62], "1024": [20, 62]}


def test_main_records_a_failure_goes_on_and_exits_1(monkeypatch, capsys):
    grids = small_grids()
    monkeypatch.setattr(fuzz_card, "grids", lambda quick: grids)
    assert fuzz_card.main(["--device", "cpu"]) == 0
    good = json.loads(capsys.readouterr().out.splitlines()[-1])["fuzz_card"]
    assert good["failures"] == [] and good["configs"] == 15

    real = dyadic_cuda.dyadic_multiply  # a product with one bit wrong
    monkeypatch.setattr(dyadic_cuda, "dyadic_multiply",
                        lambda x, y, meta: real(x, y, meta) ^ 1)
    assert fuzz_card.main(["--device", "cpu"]) == 1
    bad = json.loads(capsys.readouterr().out.splitlines()[-1])["fuzz_card"]
    assert bad["configs"] == 15  # the run went on
    assert len(bad["failures"]) == 8  # the dyadic configurations
    assert all(f["config"].startswith("dyadic") for f in bad["failures"])


def test_kernels_vs_plain_restores_the_wrappers():
    before = (ntt_cuda.ntt_fwd, ntt_cuda.ntt_fwd_mac, dyadic_cuda.dyadic_multiply)
    with fuzz_card.kernels_vs_plain({}):
        assert ntt_cuda.ntt_fwd is not before[0]
    assert (ntt_cuda.ntt_fwd, ntt_cuda.ntt_fwd_mac, dyadic_cuda.dyadic_multiply) == before


# -- the envelope's edges against the JAX package -------------------------------


@pytest.mark.parametrize("edge", ["smallest", "52"])
def test_keyswitch_edges_vs_jax_context(edge):
    """(L, K) = (1, 2) at n = 1024: the port's context in both schedules vs
    the JAX package's keyswitch_jax context and its golden model."""
    case = fuzz_card.keyswitch_edge(1024, 1, 2, edge, seed=5)
    vec = vectors.make_keyswitch_vector(1024, 1, 2, seed=5, moduli=list(case.moduli))
    args = (vec.input, vec.t_target_iter_ptr, vec.key_vectors, vec.modswitch_factors)
    want = jgolden.keyswitch(vec.input, vec.t_target_iter_ptr, 1024, 1, 2, 2, 2,
                             vec.moduli, vec.key_vectors, vec.modswitch_factors,
                             vec.twiddle_factors)
    np.testing.assert_array_equal(vec.expected_output, want)
    ref = keyswitch_jax.get_context(1024, 1, 2, 2, 2, vec.moduli, vec.twiddle_factors)
    np.testing.assert_array_equal(ref.run(*args), want)
    for fused in (False, True):
        ctx = keyswitch_cuda.KeySwitchContext(1024, 1, 2, 2, 2, vec.moduli,
                                              vec.twiddle_factors, device="cpu",
                                              fused_mac=fused)
        np.testing.assert_array_equal(ctx.run(*args), want)


@pytest.mark.parametrize("edge", ["smallest", "52"])
def test_keyswitch_edges_at_six_limbs_vs_jax_golden(edge):
    case = fuzz_card.keyswitch_edge(1024, 6, 7, edge, seed=6)
    vec = vectors.make_keyswitch_vector(1024, 6, 7, seed=6, moduli=list(case.moduli))
    want = jgolden.keyswitch(vec.input, vec.t_target_iter_ptr, 1024, 6, 7, 7, 2,
                             vec.moduli, vec.key_vectors, vec.modswitch_factors,
                             vec.twiddle_factors)
    for fused in (False, True):
        ctx = keyswitch_cuda.KeySwitchContext(1024, 6, 7, 7, 2, vec.moduli,
                                              vec.twiddle_factors, device="cpu",
                                              fused_mac=fused)
        got = ctx.run(vec.input, vec.t_target_iter_ptr, vec.key_vectors,
                      vec.modswitch_factors)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("width", [17, 52, 60])
def test_dyadic_domains_vs_jax(width):
    """Canonical operands and operands in [0, 4q) lie in MultMod's exact
    domain at every width of the grid: the plain version equals the bignum
    golden model.  Random 64-bit operands lie beyond it (the product exceeds
    2^(len + 64)): the plain version differs from the golden model there and
    follows the JAX package's traced tier bit for bit."""
    case = fuzz_card.Dyadic(256, 3, width)
    rng = np.random.default_rng(width)
    meta = dyadic_cuda.runner(case.moduli, "cpu").meta
    for factor in (1, 4, None):
        a, b = (fuzz_card.dyadic_operands(rng, case.moduli, 256, factor) for _ in range(2))
        got = w.to_u64_np(dyadic_cuda.dyadic_multiply_plain(
            w.from_u64_np(a), w.from_u64_np(b), meta))
        mods = np.array([case.moduli], dtype=np.uint64)
        np.testing.assert_array_equal(got, dyadic_jax.dyadic_multiply_batched(a, b, mods))
        exact = golden.dyadic_multiply(a, b, 256, case.moduli, 3).reshape(got.shape)
        if factor is None:
            assert (got != exact).any()
        else:
            np.testing.assert_array_equal(got, exact)


@pytest.mark.parametrize("n", [1024, 32768])
def test_62_bit_transform_vs_golden(n):
    """The largest 62-bit prime (4q within 2^2 of 2^64): the plain versions
    of ntt_fwd / ntt_inv against the JAX package's golden transforms, on the
    corner rows, canonical and 64-bit rows."""
    q = fuzz_card.width_primes(1, 62, n, top=True)[0]
    assert 4 * q > (1 << 64) - (1 << 22)
    t = twiddles.ntt_tables(n, q)
    rows = fuzz_card.transform_rows(np.random.default_rng(n), n, q)
    reduced = rows % np.uint64(q)
    tabs = ntt_cuda.modulus_tables(n, q, device="cpu")
    got = ntt_cuda.ntt_fwd(w.from_u64_np(rows), tabs)
    np.testing.assert_array_equal(w.to_u64_np(got), jgolden.fwd_ntt(reduced, q))
    np.testing.assert_array_equal(w.to_u64_np(ntt_cuda.ntt_inv(got, tabs)), reduced)
    np.testing.assert_array_equal(w.to_u64_np(ntt_cuda.ntt_inv(w.from_u64_np(rows), tabs)),
                                  jgolden.inv_ntt(reduced, q))
    assert golden.fwd_ntt(reduced, q, t).tolist() == w.to_u64_np(got).tolist()
