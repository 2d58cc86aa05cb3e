"""The plain reference against the port's plain flagger, and its bfloat16 control."""

import pytest
import torch

from flagbench import data, harness, reference
from katsdpsigproc_tpu_torch.models.rfi import fused_flagger

SPEC = harness.load_spec()
FLAGGER = harness.load_config(SPEC, "meerkat-l-32k")["flagger"]
DATA = harness.load_traffic("resident")["data"]


def dump(seed, channels, rows):
    return data.make_dump(data.generator(seed, "cpu"), channels, rows, DATA, "cpu")


def mask(channels, seed=3):
    gen = torch.Generator().manual_seed(seed)
    return (torch.rand(channels, generator=gen) < 0.3).to(torch.uint8)


@pytest.mark.parametrize("mode", ["none", "channel"])
@pytest.mark.parametrize("shape", [(512, 16), (1000, 7), (4096, 32)])
@pytest.mark.parametrize("seed", [1, 2**31 + 5])
def test_matches_the_port_flag_for_flag(mode, shape, seed):
    vis = dump(seed, *shape)
    channel_flags = mask(shape[0]) if mode == "channel" else None
    ref = reference.flag_dump(vis, FLAGGER, channel_flags)
    port = fused_flagger.flag_transposed_plain(vis.transpose(0, 1), channel_flags=channel_flags,
                                              **FLAGGER)
    assert ref.shape == (shape[1], shape[0]) and ref.dtype == torch.uint8
    assert torch.equal(ref, port)
    assert 0 < int(ref.sum()) < ref.numel()


def test_blocks_of_rows_give_the_same_flags(monkeypatch):
    vis = dump(7, 512, 24)
    whole = reference.flag_dump(vis, FLAGGER)
    monkeypatch.setattr(reference, "block_rows", lambda channels, width: 5)
    assert torch.equal(reference.flag_dump(vis, FLAGGER), whole)


@pytest.mark.parametrize("mode", ["none", "channel"])
def test_bfloat16_control_does_not_pass(mode):
    """The control, the reference in bfloat16, fails the limit of 0 mismatching flags."""
    vis = dump(11, 4096, 64)
    channel_flags = mask(4096) if mode == "channel" else None
    exact = reference.flag_dump(vis, FLAGGER, channel_flags)
    low = reference.flag_dump(vis, FLAGGER, channel_flags, dtype=torch.bfloat16)
    assert int((exact != low).sum()) > 0


def test_sqrt_rn_is_correctly_rounded():
    x = torch.rand(100000, dtype=torch.float32) * 1000
    y = reference.sqrt_rn(x).to(torch.float64)
    exact = torch.sqrt(x.to(torch.float64))
    up = torch.nextafter(y.float(), torch.tensor(float("inf"))).double()
    down = torch.nextafter(y.float(), torch.tensor(float("-inf"))).double()
    assert bool(((exact - y).abs() <= (up - exact).abs()).all())
    assert bool(((exact - y).abs() <= (exact - down).abs()).all())
