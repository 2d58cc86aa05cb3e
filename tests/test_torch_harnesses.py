"""The port's CLI harnesses (``katsdpsigproc_tpu_torch/scripts``) on the CPU
(``--device cpu``) at small sizes.

``rfiflagtest`` and ``fftflagtest`` must print "Mask mismatches: 0 / N"
and exit 0: the 1-D engines against the numpy host oracle, the 2-D
flagger (``--time``) against the numpy 2-D oracle, the FFT path against a
numpy float64 run (bins within 1e-5 of their threshold, relative, counted
apart).  ``transposetest`` must print "Mismatches: 0 / N" (the whole
output against numpy's ``.T``, bit for bit), ``percentiletest`` "exact
match vs np.percentile(..., 'lower')", ``maskedsumtest`` and
``maskedsumabstest`` "Mismatches: 0 / N" at the harness's rtol 1e-4 /
atol 1e-3 against numpy, each exiting 0.  The data are the harnesses'
own, from seed 1.  On the same data the harnesses' results are held to
the JAX ops': the transpose and the percentiles bit for bit (JAX's Pallas
engines in interpret mode, as ``tests/test_torch_ops.py`` runs them), the
masked sums at rtol 1e-5 / atol 1e-5 (torch and XLA sum in different
orders).
"""

import re

import numpy as np
import pytest
import torch

from katsdpsigproc_tpu_torch.models.rfi.device import to_planar
from katsdpsigproc_tpu_torch.ops import maskedsum, transpose
from katsdpsigproc_tpu_torch.pytest_plugin import patch_autotune  # noqa: F401
from katsdpsigproc_tpu_torch.scripts import (fftflagtest, maskedsumabstest, maskedsumtest,
                                             percentiletest, rfiflagtest, transposetest,
                                             tune_all)
from katsdpsigproc_tpu_torch.utils import backend

CPU = torch.device("cpu")


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


@pytest.mark.parametrize("main", [rfiflagtest.main, fftflagtest.main, transposetest.main,
                                  percentiletest.main, maskedsumtest.main,
                                  maskedsumabstest.main, tune_all.main])
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


def _exit_0(main, argv, capsys):
    with pytest.raises(SystemExit) as exit_info:
        main(argv)
    err = capsys.readouterr().err
    assert exit_info.value.code == 0, err
    return err


@pytest.mark.parametrize("engine", ["torch", "cuda"])
def test_transposetest(engine, capsys):
    err = _exit_0(transposetest.main, ["--device", "cpu", "--rows", "96", "--cols", "200",
                                       "--engine", engine, "--iters", "2"], capsys)
    assert f"engine: {engine}" in err
    assert "Mismatches: 0 / 19200" in err, err
    assert re.search(r"time on cpu: [0-9.]+ ms/iter \(host clock, median of 2\), [0-9.]+ GB/s "
                     r"effective \[cpu\]", err), err


def test_transposetest_takes_the_tuned_engine(patch_autotune, capsys):  # noqa: F811
    err = _exit_0(transposetest.main, ["--device", "cpu", "--rows", "8", "--cols", "9"], capsys)
    assert "engine: torch" in err and "Mismatches: 0 / 72" in err, err


@pytest.mark.parametrize("jax_engine", ["xla", "pallas"])
def test_transposetest_matches_the_jax_op(jax_engine):
    """The harness's source and template against JAX's transpose of the same
    planar data, with the JAX harness's tiles (the Pallas kernel in
    interpret mode)."""
    import jax.numpy as jnp

    from katsdpsigproc_tpu.ops import transpose as jtr

    src = transposetest.make_source(100, 300)
    planar = to_planar(src)
    jtmpl = jtr.TransposeTemplate(None, np.complex64,
                                  tuning={"engine": jax_engine, "tile_r": 256, "tile_c": 256})
    want = np.asarray(jtr.transpose(jnp.asarray(planar), jtmpl, interpret=True))
    template = transposetest.make_template(CPU, {"xla": "torch", "pallas": "cuda"}[jax_engine])
    got = transpose.transpose(torch.from_numpy(planar), template).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(got, to_planar(src.T))


@pytest.mark.parametrize("engine", ["rank", "sort", "cuda"])
def test_percentiletest(engine, capsys):
    err = _exit_0(percentiletest.main, ["--device", "cpu", "--rows", "40", "--cols", "301",
                                        "--engine", engine, "--iters", "2"], capsys)
    assert f"engine: {engine}" in err
    assert "exact match vs np.percentile(..., 'lower')" in err, err
    assert re.search(r"time on cpu: [0-9.]+ ms/iter \(host clock, median of 2\)", err), err


def test_percentiletest_takes_the_tuned_engine(patch_autotune, capsys):  # noqa: F811
    err = _exit_0(percentiletest.main, ["--device", "cpu", "--rows", "5", "--cols", "8"],
                  capsys)
    assert "engine: rank" in err and "exact match" in err, err


@pytest.mark.parametrize("cols", [301, 4096])
def test_percentiletest_matches_the_jax_op(cols):
    """Every engine of the harness's op against JAX's Pallas engine (interpret
    mode) on the harness's seed-1 amplitudes, bit for bit."""
    import jax.numpy as jnp

    from katsdpsigproc_tpu.ops import percentile as jpct

    src = percentiletest.make_source(24, cols)
    jop = jpct.Percentile5Template(None, cols, True, tuning={"engine": "pallas"}).instantiate(
        None, src.shape)
    want = np.asarray(jop(src=jnp.asarray(src))["dest"])
    np.testing.assert_array_equal(want, percentiletest.expected(src))
    for engine in ("rank", "sort", "cuda"):
        got = percentiletest.make_op(CPU, src.shape, engine)(src=torch.from_numpy(src))["dest"]
        np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32),
                                      err_msg=engine)


@pytest.mark.parametrize("amplitudes", [False, True])
def test_maskedsumtest(amplitudes, capsys):
    argv = ["--device", "cpu", "--rows", "128", "--cols", "300", "--iters", "2"]
    err = _exit_0(maskedsumtest.main, argv + (["--amplitudes"] if amplitudes else []), capsys)
    assert f"Mismatches: 0 / {300 if amplitudes else 600} (rtol 0.0001, atol 0.001" in err, err
    assert re.search(r"time on cpu: [0-9.]+ ms/iter \(host clock, median of 2\)", err), err


def test_maskedsumabstest_is_maskedsumtest_of_amplitudes(capsys):
    argv = ["--device", "cpu", "--rows", "128", "--cols", "300", "--iters", "2"]
    err = _exit_0(maskedsumabstest.main, argv, capsys)
    want = _exit_0(maskedsumtest.main, ["--amplitudes"] + argv, capsys)
    assert "Mismatches: 0 / 300 " in err, err
    assert err.splitlines()[1] == want.splitlines()[1]  # the same parity line


@pytest.mark.parametrize("amplitudes", [False, True])
def test_maskedsumtest_matches_the_jax_op(amplitudes):
    """The harness's sums against JAX's maskedsum on the same seeded planar
    data and mask, rtol 1e-5 / atol 1e-5."""
    import jax.numpy as jnp

    from katsdpsigproc_tpu.ops import maskedsum as jms

    src, mask = maskedsumtest.make_source(500, 300)
    planar = to_planar(src)
    want = np.asarray(jms.maskedsum(jnp.asarray(planar), jnp.asarray(mask), amplitudes))
    got = maskedsum.maskedsum(torch.from_numpy(planar), torch.from_numpy(mask), amplitudes)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), maskedsumtest.expected(src, mask, amplitudes),
                               rtol=maskedsumtest.RTOL, atol=maskedsumtest.ATOL)
