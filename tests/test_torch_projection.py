"""The port's scaling model against the reference's formulas.  The
reference's accelerator constants stay here, read from its module and passed
as arguments: the port holds none of them."""

from dataclasses import asdict

import pytest

from hexl_fpga_tpu.parallel import projection as ref
from hexl_fpga_tpu_torch.parallel import projection

REF_LINK = ref.ICI_BW["v5e"]
REF_ALPHA = 0.65  # the reference's default transform share
REF_COLLECTIVE_MS = 0.01  # the reference's per-collective floor


@pytest.mark.parametrize("P", [1, 2, 3, 4, 8])
def test_keyswitch_models_equal_the_reference(P):
    for t1, batch in ((9.4, 32), (3.1, 8)):
        assert asdict(projection.keyswitch_mp_projection(
            P, t1, batch, REF_ALPHA, REF_LINK, REF_COLLECTIVE_MS)) == asdict(
            ref.keyswitch_mp_projection(P, t1, batch))
        assert asdict(projection.keyswitch_hoisted_mp_projection(
            P, t1, 0.7 * t1, batch, REF_ALPHA, REF_LINK, REF_COLLECTIVE_MS)) == asdict(
            ref.keyswitch_hoisted_mp_projection(P, t1, 0.7 * t1, batch))
    # other shapes and parts
    assert asdict(projection.keyswitch_mp_projection(
        P, 5.0, 16, 0.5, ref.ICI_BW["v5p"], REF_COLLECTIVE_MS, n=8192, L=5)) == asdict(
        ref.keyswitch_mp_projection(P, 5.0, 16, n=8192, L=5, alpha=0.5, part="v5p"))


@pytest.mark.parametrize("P", [1, 2, 4, 8])
@pytest.mark.parametrize("chunks", [1, 4])
def test_sp_model_equals_the_reference(P, chunks):
    assert asdict(projection.dist_ntt_sp_projection(
        P, 15.2, 4096, REF_LINK, REF_COLLECTIVE_MS, chunks=chunks)) == asdict(
        ref.dist_ntt_sp_projection(P, 15.2, 4096, chunks=chunks))


@pytest.mark.parametrize("P", [2, 4, 8])
def test_binary_exchange_bytes(P):
    """The port's exchange: log2(P) whole blocks of n/P u64 a rank."""
    batch, n, link = 32, 16384, 1e11
    p = projection.dist_ntt_sp_projection(
        P, 1.0, batch, link, 0.0, n=n, chunks=1,
        bytes_per_coeff=projection.binary_exchange_bytes_per_coeff(P))
    want_ms = (P.bit_length() - 1) * batch * (n // P) * 8 / link * 1e3
    assert p.comm_ms == round(want_ms, 4)


def test_the_port_holds_no_reference_accelerator_constant():
    assert not hasattr(projection, "ICI_BW")
    assert not hasattr(projection, "DCN_BW_PER_HOST")
    assert projection.NVLINK4_BYTES_PER_S_PER_DIRECTION == 450e9
    with pytest.raises(TypeError):
        projection.report()  # every time is an argument
    text = projection.report(2.0, 1.5, 0.1, 0.4, 0.05, device="a card")
    assert text.startswith("scaling MODEL, not a measurement")
    assert "mp KeySwitch P=8" in text and "sp NTT" in text and "a card" in text
    for reference_default in ("9.4", "15.2", "6.3", "v5e", "v5p"):
        assert reference_default not in text
