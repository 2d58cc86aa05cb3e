"""The port's fused flagger (katsdpsigproc_tpu_torch.models.rfi.fused_flagger)
on the CPU, where each wrapper takes its plain PyTorch version, against the
JAX Pallas kernels in interpret mode, the JAX engines and the host oracles.

Tolerance: exact on every uint8 mask.  The JAX kernels run under jit,
where XLA on the CPU contracts re*re + im*im into an FMA (see
tests/test_torch_device.py); at these sizes no amplitude sits close
enough to a threshold or a median tie for that ulp to flip a flag, and
the masks are compared bit for bit.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from katsdpsigproc_tpu.models.rfi import device as jdev, host as jhost, pallas_flagger as jpf
from katsdpsigproc_tpu_torch.models.rfi import device as tdev, fused_flagger as ff, host as thost

from .helpers import rfi_test_data

ROOT = Path(__file__).resolve().parent.parent
PARAMS = dict(width=13, n_sigma=11.0, n_windows=4, falloff=1.2, flag_value=1)


def _host_flagger(host, n_windows=4):
    return host.FlaggerHost(host.BackgroundMedianFilterHost(13), host.NoiseEstMADHost(),
                            host.ThresholdSumHost(11.0, n_windows=n_windows))


def _vis_t(vis):
    return np.moveaxis(jdev.to_planar(vis), 0, 1).copy()  # (B, C, 2)


@pytest.mark.parametrize("channels,baselines", [(128, 16), (300, 8), (99, 8), (257, 8)])
def test_flag_transposed_matches_pallas_and_host(channels, baselines):
    # 99/257 channels flip the right-edge fill parity of the fast path.
    vis, _, _ = rfi_test_data(shape=(channels, baselines), seed=3)
    vt = _vis_t(vis)
    got = ff.flag_transposed(torch.from_numpy(vt), **PARAMS)
    want = jpf.flag_transposed(jnp.asarray(vt), bb=baselines, interpret=True, **PARAMS)
    assert got.dtype == torch.uint8 and got.shape == (baselines, channels)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy().T, _host_flagger(thost)(vis))


def test_flag_transposed_matches_pallas_dma():
    rs = np.random.RandomState(3)
    vt = rs.standard_normal((16, 300, 2)).astype(np.float32)
    vt[:, 120, :] *= 40.0
    got = ff.flag_transposed(torch.from_numpy(vt), **PARAMS)
    want = jpf.flag_transposed_dma(jnp.asarray(vt), bb=8, interpret=True, **PARAMS)
    assert got.any()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_large_windows_and_flag_value_match_pallas():
    vis, _, _ = rfi_test_data(shape=(384, 8), seed=11)
    vt = _vis_t(vis)
    kw = {**PARAMS, "n_windows": 6, "flag_value": 3}
    got = ff.flag_transposed(torch.from_numpy(vt), **kw)
    want = jpf.flag_transposed(jnp.asarray(vt), bb=8, fold=128, interpret=True, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy().T, 3 * _host_flagger(thost, n_windows=6)(vis))


@pytest.mark.parametrize("mode", ["full", "channel"])
def test_input_flags_match_pallas_and_host(mode):
    vis, _, input_flags = rfi_test_data(shape=(256, 8), seed=6)
    vt = torch.from_numpy(_vis_t(vis))
    if mode == "channel":
        host_arg = input_flags[:, 0]
        kw = {"channel_flags": host_arg.astype(np.uint8)}
    else:
        host_arg = input_flags
        kw = {"input_flags": input_flags.T.astype(np.uint8).copy()}
    got = ff.flag_transposed(vt, **{k: torch.from_numpy(v) for k, v in kw.items()}, **PARAMS)
    want = jpf.flag_transposed(jnp.asarray(vt.numpy()), bb=8, fold=128, interpret=True,
                               **{k: jnp.asarray(v) for k, v in kw.items()}, **PARAMS)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy().T, _host_flagger(jhost)(vis, host_arg))


@pytest.mark.parametrize("nref", [1, 2])
def test_madnz_threshold_matches_pallas(nref):
    rs = np.random.RandomState(13)
    dev_t = rs.standard_normal((16, 256)).astype(np.float32)
    dev_t[:, 80] += 30.0
    kw = dict(n_sigma=11.0, n_windows=4, falloff=1.2, flag_value=1)
    got = ff.madnz_threshold(torch.from_numpy(dev_t), **kw)
    want = jpf.madnz_threshold(jnp.asarray(dev_t), bb=4, fold=128, interpret=True, nref=nref,
                               **kw)
    assert got.any()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(ff.madnz_threshold_plain(torch.from_numpy(dev_t), **kw).numpy(),
                                  got.numpy())


def _seed1_dump(channels=512, rows=64):
    """The benchmark's seed-1 dump recipe (bench.py:361-366) at a small size."""
    rs = np.random.RandomState(seed=1)
    shape = (channels, rows)
    vis = (rs.standard_normal(shape) + 1j * rs.standard_normal(shape)).astype(np.complex64)
    spikes = rs.random_sample(shape) < 1.0 / 64.0
    vis += spikes * (rs.random_sample(shape) * 20.0 + 50.0)
    return vis


def test_slice_matches_jax_engines_and_host_oracles():
    """The whole slice: flag_dump on the corner-turned dump and make_flagger_fn
    ("torch", "hybrid") on the channel-major (512, 64, 2) seed-1 dump equal the
    JAX engine, the JAX host oracle and the port's host copy."""
    vis = _seed1_dump()
    planar = jdev.to_planar(vis)  # (C, B, 2)
    expected = _host_flagger(jhost)(vis)
    np.testing.assert_array_equal(_host_flagger(thost)(vis), expected)
    assert expected.any()
    jax_xla = np.asarray(jdev.make_flagger_fn(13, 11.0)(jnp.asarray(planar)))
    np.testing.assert_array_equal(jax_xla, expected)
    vis_c = torch.from_numpy(planar)
    dump = ff.flag_dump(vis_c.transpose(0, 1).contiguous(), **PARAMS)
    np.testing.assert_array_equal(dump.numpy().T, expected)
    for engine, block in [("torch", None), ("hybrid", None), ("hybrid", 24)]:
        fn = tdev.make_flagger_fn(13, 11.0, engine=engine, baseline_block=block)
        np.testing.assert_array_equal(fn(vis_c).numpy(), expected, err_msg=engine)


def test_hybrid_engine_matches_jax_hybrid():
    vis, _, _ = rfi_test_data(shape=(256, 16), seed=15)
    planar = jdev.to_planar(vis)
    ref = jdev.make_flagger_fn(13, 11.0, engine="hybrid",
                               pallas_kw=dict(bb=4, fold=128, interpret=True))
    got = tdev.make_flagger_fn(13, 11.0, engine="hybrid")(torch.from_numpy(planar))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref(jnp.asarray(planar))))


def test_cpu_tensors_take_the_plain_versions():
    vis, _, _ = rfi_test_data(shape=(128, 8), seed=4)
    vt = torch.from_numpy(_vis_t(vis))
    before = dict(ff.launches)
    np.testing.assert_array_equal(ff.flag_transposed(vt).numpy(),
                                  ff.flag_transposed_plain(vt).numpy())
    assert ff.launches == before  # no kernel ran, so nothing was counted


def test_validation():
    vt = torch.zeros((4, 64, 2))
    with pytest.raises(ValueError, match="not both"):
        ff.flag_transposed(vt, torch.zeros((4, 64), dtype=torch.uint8),
                           channel_flags=torch.zeros(64, dtype=torch.uint8))
    with pytest.raises(ValueError, match="width"):
        ff.flag_transposed(vt, width=12)
    with pytest.raises(ValueError, match="flag_value"):
        ff.flag_transposed(vt, flag_value=256)
    with pytest.raises(TypeError, match="float32"):
        ff.flag_transposed(vt.double())
    with pytest.raises(ValueError, match="shape"):
        ff.flag_transposed(vt, torch.zeros((4, 63), dtype=torch.uint8))
    with pytest.raises(TypeError, match="uint8"):
        ff.flag_transposed(vt, channel_flags=torch.zeros(64, dtype=torch.int32))
    with pytest.raises(ValueError, match="rows, channels, 2"):
        ff.flag_transposed(torch.zeros((4, 64)))
    with pytest.raises(TypeError, match="float32"):
        ff.madnz_threshold(torch.zeros((4, 64), dtype=torch.float64))


def test_network_header_renders_the_port_networks():
    text = ff._network_header(13)
    assert "#define FF_WIDTH 13" in text
    fast = next(line for line in text.splitlines() if line.startswith("#define FF_NET_FAST"))
    assert fast.count("FF_CE_") == len(tdev.rank_ops.selection_network(13, (6, 7)))
    assert "FF_CE_BOTH(w, 0, 8) FF_CE_BOTH(w, 0, 12)" in fast


def test_port_runs_without_jax():
    """A subprocess where `import jax` fails imports the port and flags a dump."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import numpy as np, torch\n"
        "import katsdpsigproc_tpu_torch as port\n"
        "from katsdpsigproc_tpu_torch.models.rfi import fused_flagger, device\n"
        "rs = np.random.RandomState(0)\n"
        "v = rs.standard_normal((8, 96, 2)).astype(np.float32); v[:, 40] *= 50\n"
        "f = fused_flagger.flag_dump(torch.from_numpy(v))\n"
        "assert f.shape == (8, 96) and f[:, 40].all(), f\n"
        "assert 'katsdpsigproc_tpu' not in sys.modules\n"
        "print('ok', port.__version__, port.MAD_NORMAL)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok 0.5.0 1.4826")
