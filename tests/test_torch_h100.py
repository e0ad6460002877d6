"""The H100 figures the port reads live in one place,
`repro_torch.configs.base`, with the values of NVIDIA's H100 SXM data
sheet that `chip_smoke.py` and `api/autotune.py` held before; both read
them from there, and the reference's TPU constants are not among them."""
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]

DATA_SHEET = {"H100_HBM_BYTES_PER_S": 3.35e12, "H100_F32_FLOPS": 67e12,
              "H100_BF16_TC_FLOPS": 989e12, "H100_NVLINK_GBPS": 450.0,
              "H100_NDR_GBPS": 50.0}


@pytest.mark.parametrize("name", sorted(DATA_SHEET))
def test_h100_constant_unchanged(name):
    from repro_torch.configs import base

    assert getattr(base, name) == DATA_SHEET[name]


def test_chip_smoke_bounds_read_the_configs():
    from repro_torch.configs import base

    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    assert chip_smoke.HBM_BYTES_PER_S is base.H100_HBM_BYTES_PER_S
    assert chip_smoke.F32_FLOPS is base.H100_F32_FLOPS
    assert chip_smoke.BF16_TC_FLOPS is base.H100_BF16_TC_FLOPS
    # a bytes-bound call: 3.35 GB in one millisecond
    assert chip_smoke.bound(3.35e9, 0)[0] == pytest.approx(1.0)


def test_autotune_wire_speeds_read_the_configs():
    from repro_torch.api.autotune import WireBandwidth
    from repro_torch.configs import base

    bw = WireBandwidth()
    assert bw.inner_gbps == base.H100_NVLINK_GBPS
    assert bw.outer_gbps == base.H100_NDR_GBPS
    assert not any(hasattr(base, n) for n in ("PEAK_FLOPS_BF16", "HBM_BW",
                                              "ICI_BW", "HBM_BYTES"))
