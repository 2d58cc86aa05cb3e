"""The CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips where CUDA is unavailable.
This file imports no jax, so it also runs on a machine without it; there
the JAX package's test configuration must not be loaded:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerance: exact on every uint8 mask (the kernels round each operation
as the plain versions do).
"""

import numpy as np
import pytest
import torch

from katsdpsigproc_tpu_torch.models.rfi import device, fused_flagger as ff

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _dump(channels, rows, seed):
    rs = np.random.RandomState(seed)
    vis_t = rs.standard_normal((rows, channels, 2)).astype(np.float32)
    spikes = rs.random_sample((rows, channels)) < 1.0 / 32.0
    vis_t[spikes] *= 40.0
    flags = ((rs.random_sample((rows, channels)) < 1.0 / 16.0) * 2).astype(np.uint8)
    return torch.from_numpy(vis_t), torch.from_numpy(flags)


@pytest.mark.parametrize("channels,rows", [(99, 8), (300, 8), (2048, 6), (32768, 2)])
@pytest.mark.parametrize("mode", ["none", "full", "channel"])
def test_flagger_matches_plain(cuda, channels, rows, mode):
    vis_t, flags = _dump(channels, rows, seed=channels + rows)
    vis_t, flags = vis_t.to(cuda), flags.to(cuda)
    kw = {"none": {}, "full": {"input_flags": flags},
          "channel": {"channel_flags": flags[0].contiguous()}}[mode]
    got = ff.flag_transposed(vis_t, **kw)
    want = ff.flag_transposed_plain(vis_t, **kw)
    assert got.device == vis_t.device and got.any()
    assert torch.equal(got, want)


@pytest.mark.parametrize("n_windows,flag_value", [(1, 1), (4, 2), (6, 3), (9, 1)])
def test_madnz_threshold_matches_plain(cuda, n_windows, flag_value):
    vis_t, _ = _dump(1000, 8, seed=n_windows)
    vis_t = vis_t.to(cuda)
    dev_t = device.background_median_filter(
        vis_t.transpose(0, 1), None, 13, False, device.BackgroundFlags.NONE).T.contiguous()
    dev_t[3, 200:230] += 0.8  # a broad, weak feature only the wide windows catch
    kw = dict(n_sigma=11.0, n_windows=n_windows, falloff=1.2, flag_value=flag_value)
    assert torch.equal(ff.madnz_threshold(dev_t, **kw), ff.madnz_threshold_plain(dev_t, **kw))


def test_nan_row_propagates_like_jax(cuda):
    vis_t, _ = _dump(300, 4, seed=1)
    vis_t[1, 17, 0] = float("nan")
    vis_t[2, 0, 1] = float("nan")
    vis_t = vis_t.to(cuda)
    assert torch.equal(ff.flag_transposed(vis_t), ff.flag_transposed_plain(vis_t))


def test_launch_counter_moves(cuda):
    vis_t, _ = _dump(256, 4, seed=2)
    vis_t = vis_t.to(cuda)
    before = dict(ff.launches)
    flags = ff.flag_dump(vis_t)
    ff.madnz_threshold(torch.zeros((4, 256), device=cuda))
    device.make_flagger_fn(engine="hybrid", baseline_block=2)(vis_t.transpose(0, 1))
    torch.cuda.synchronize()
    assert ff.launches["flagger"] == before["flagger"] + 1
    assert ff.launches["madnz_threshold"] == before["madnz_threshold"] + 1 + 2
    assert flags.device == vis_t.device


def test_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    vis_t = torch.zeros((4, 64, 2), device=cuda)
    with pytest.raises(TypeError, match="float32"):
        ff.flag_transposed(vis_t.double())
    with pytest.raises(TypeError, match="float32"):
        ff.madnz_threshold(torch.zeros((4, 64), dtype=torch.float16, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        ff.flag_transposed(torch.zeros((64, 4, 2), device=cuda).transpose(0, 1))
    with pytest.raises(ValueError, match="on cpu"):
        ff.flag_transposed(vis_t, torch.zeros((4, 64), dtype=torch.uint8))
    with pytest.raises(ValueError, match="limit"):
        ff.madnz_threshold(torch.zeros((1, 50000), device=cuda))
