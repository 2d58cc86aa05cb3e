"""The port's CLI harnesses ``scripts/rfiflagtest`` and ``scripts/fftflagtest``
on the CPU (``--device cpu``) at small sizes.

Each must print "Mask mismatches: 0 / N" and exit 0: the 1-D engines
against the numpy host oracle, the 2-D flagger (``--time``) against the
numpy 2-D oracle, the FFT path against a numpy float64 run (bins within
1e-5 of their threshold, relative, counted apart).  The data are the
harnesses' own, from seed 1.
"""

import re

import numpy as np
import pytest
import torch

from katsdpsigproc_tpu_torch.scripts import fftflagtest, rfiflagtest
from katsdpsigproc_tpu_torch.utils import backend


def _run(main, argv, capsys):
    with pytest.raises(SystemExit) as exit_info:
        main(argv)
    err = capsys.readouterr().err
    assert exit_info.value.code == 0, err
    match = re.search(r"Mask mismatches: (\d+) / (\d+)", err)
    assert match and match.group(1) == "0" and int(match.group(2)) > 0, err
    return err


@pytest.mark.parametrize("engine", ["torch", "hybrid", "cuda"])
def test_rfiflagtest_1d(engine, capsys):
    err = _run(rfiflagtest.main, ["--device", "cpu", "--channels", "256", "--baselines", "16",
                                  "--engine", engine], capsys)
    assert "Device steady-state" in err and "Host (oracle)" in err


def test_rfiflagtest_2d(capsys):
    err = _run(rfiflagtest.main, ["--device", "cpu", "--time", "48", "--channels", "300",
                                  "--baselines", "2"], capsys)
    fraction = float(re.search(r"Flagged fraction: ([0-9.]+)", err).group(1))
    assert 0 < fraction < 1


def test_fftflagtest(capsys):
    err = _run(fftflagtest.main, ["--device", "cpu", "--baselines", "16", "--channels", "4096",
                                  "--iters", "2"], capsys)
    assert re.search(r"flagged spectral bins: [1-9]", err)
    assert re.search(r"ms/iter, [0-9.]+ Gsamples/s", err)


def test_fftflagtest_matches_the_jax_pipeline():
    """The port's Fft r2c/c2r composition flags the bins the JAX harness's
    jnp.fft pipeline flags, apart from bins near the threshold."""
    import jax.numpy as jnp

    from katsdpsigproc_tpu.ops import rank as jrank

    data = fftflagtest.make_data(16, 4096)
    spectrum = jnp.fft.rfft(jnp.asarray(data), axis=-1)
    amp = jnp.abs(spectrum).astype(jnp.float32)
    noise = fftflagtest.MAD_NORMAL * jrank.median_non_zero(amp)
    want = np.asarray(amp > 5.0 * noise[:, None])
    want_out = np.asarray(jnp.fft.irfft(jnp.where(want, 0.0, spectrum), n=4096, axis=-1))
    context = backend.DeviceContext(torch.device("cpu"))
    flags, out = fftflagtest.make_spectral_flag(context, 16, 4096, 5.0)(torch.from_numpy(data))
    _, near = fftflagtest.reference_flags(data, 5.0)
    assert want.any()
    np.testing.assert_array_equal((flags.numpy() != 0)[~near], want[~near])
    np.testing.assert_allclose(out.numpy(), want_out, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("main", [rfiflagtest.main, fftflagtest.main])
def test_harnesses_need_a_card_unless_asked_for_the_cpu(main, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        main([])


def test_rfiflagtest_generate_data_is_the_reference_harness():
    """generate_data is scripts/rfiflagtest.py's, array for array."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "scripts" / "rfiflagtest.py"
    spec = importlib.util.spec_from_file_location("jax_rfiflagtest", path)
    jax_script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_script)
    for times in (None, 5):
        np.testing.assert_array_equal(rfiflagtest.generate_data(times, 33, 4),
                                      jax_script.generate_data(times, 33, 4))
