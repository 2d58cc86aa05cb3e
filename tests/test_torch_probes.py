"""K1's stage probes (katsdpsigproc_tpu_torch.models.rfi.flagger_probe) on
the CPU, where each wrapper takes its plain PyTorch version, against the
TPU probes of ``scripts/`` run in interpret mode.

The JAX scripts are loaded by path, unedited.  K11 (``stage_ablate``), K13
(``rankpair_ab``) and K9 (``rollchain_ab``: its "direct" median against
``full``, its "chained" one against ``shfl_median`` and
``window_median``) run their Pallas kernels with ``interpret=True`` at
8 rows of 256 and 257 channels (257 flips the right edge's fill parity);
K12 (``deinterleave_probe``) hard-codes the TPU's
compiler parameters and has no interpret path, so the port is held to
the script's own numpy expectation (``deinterleave_probe.py:88-92``).
``radix_select``'s search, step by step in PyTorch
(``flagger_probe.madnz_radix_plain``), is held to the port's and the JAX
package's rank searches on rows of NaN, +inf, zeros and ties.

Tolerance: exact throughout, on every uint8 mask, every float32
amplitude and every noise (bit for bit; where the float-compare search
ends at its NaN end state, the integer-digit searches end at +inf or a
NaN, and there the noises are held to that).  The JAX kernels run under jit, where XLA on the CPU may
contract re*re + im*im into an FMA (see tests/test_torch_device.py); at
these sizes no amplitude sits close enough to a threshold, a median tie
or the skeleton's 1.0 for that ulp to flip a flag.
"""

import contextlib
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from katsdpsigproc_tpu.models.rfi import device as jdev, pallas_flagger as jpf
from katsdpsigproc_tpu_torch.models.rfi import flagger_probe as fp, fused_flagger as ff
from katsdpsigproc_tpu_torch.scripts import (common, deinterleave_probe, rankpair_ab,
                                             rollchain_ab, stage_ablate)
from katsdpsigproc_tpu_torch.utils import kernels

from .helpers import rfi_test_data

ROOT = Path(__file__).resolve().parent.parent


@contextlib.contextmanager
def _environment_kept():
    """Undo what a script does to the process when it is imported."""
    env, path = dict(os.environ), list(sys.path)
    try:
        yield
    finally:
        for key in set(os.environ) - set(env):
            del os.environ[key]
        os.environ.update(env)
        sys.path[:] = path


def _script(name: str):
    spec = importlib.util.spec_from_file_location(f"_jax_probe_{name}",
                                                  ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    with _environment_kept():
        spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def scripts():
    return {name: _script(name) for name in ("stage_ablate", "rankpair_ab", "rollchain_ab")}


def _vis_t(channels: int, seed: int = 5) -> np.ndarray:
    vis, _, _ = rfi_test_data(shape=(channels, 8), seed=seed)
    return np.moveaxis(jdev.to_planar(vis), 0, 1).copy()  # (8, channels, 2)


def _port(vt: np.ndarray, variant: str) -> np.ndarray:
    got = fp.probe(torch.from_numpy(vt), variant)
    assert got.dtype == torch.uint8 and got.shape == vt.shape[:2]
    return got.numpy()


@pytest.mark.parametrize("channels", [256, 257])
@pytest.mark.parametrize("variant", fp.STAGE_ABLATE)
def test_stage_ablate_matches_the_tpu_probe(scripts, variant, channels):
    vt = _vis_t(channels)
    run = scripts["stage_ablate"].make_fn(variant, bb=8, fold=channels, channels=channels,
                                          width=13, interpret=True)
    want = np.asarray(run(jnp.asarray(vt)))
    np.testing.assert_array_equal(_port(vt, variant), want)
    assert want.any()


@pytest.mark.parametrize("channels", [256, 257])
@pytest.mark.parametrize("variant,kw", [
    ("full", {}),  # the script's "binary"
    ("rank_pair", {"rank_pair": True}),  # "pair_i32"
    ("rank_pair", {"rank_pair": "f32"}),  # "pair_f32": one variant on the card
    ("zeros_fold", {"zeros_fold": True}),
    ("radix_select", {}),  # K4's radix select, against the binary search
    ("radix_select", {"rank_radix": 4}),  # and the JAX kernel's own 4-bit rounds
])
def test_rankpair_matches_the_tpu_probe(scripts, variant, kw, channels):
    vt = _vis_t(channels, seed=6)
    run = scripts["rankpair_ab"].make(kw, B=8, C=channels, fold=channels, bb=8, interpret=True)
    want = np.asarray(run(jnp.asarray(vt)))
    np.testing.assert_array_equal(_port(vt, variant), want)
    assert want.any()


@pytest.mark.parametrize("channels", [256, 257])
@pytest.mark.parametrize("variant,median", [("full", "direct"), ("shfl_median", "chained"),
                                           ("window_median", "chained")])
def test_rollchain_matches_the_tpu_probe(scripts, variant, median, channels):
    module = scripts["rollchain_ab"]
    fn = jpf._median_parity_fill if median == "direct" else module._median_incremental
    vt = _vis_t(channels, seed=7)
    want = np.asarray(module.make(fn, B=8, C=channels, fold=channels, bb=8,
                                  interpret=True)(jnp.asarray(vt)))
    np.testing.assert_array_equal(_port(vt, variant), want)
    assert want.any()


@pytest.mark.parametrize("channel_major", [False, True])
def test_amp_pairs_matches_the_scripts_expectation(channel_major):
    # deinterleave_probe.py:88-92 at a small grid: (grid * rows, 2 * width)
    # interleaved pairs and their amplitudes in float32 numpy.
    grid, rows, width = 3, 8, 256
    rs = np.random.RandomState(1)
    host = rs.standard_normal((grid * rows, 2 * width)).astype(np.float32)
    pairs = host.reshape(grid * rows, width, 2)
    expected = np.sqrt(pairs[..., 0] ** 2 + pairs[..., 1] ** 2)
    vis = torch.from_numpy(pairs)
    if channel_major:
        vis = vis.transpose(0, 1).contiguous()
    got = fp.amp_pairs(vis, channel_major=channel_major)
    assert got.dtype == torch.float32 and got.shape == expected.shape
    np.testing.assert_array_equal(got.numpy().view(np.int32), expected.view(np.int32))


@pytest.mark.parametrize("channels,rows", [(256, 8), (257, 8), (256, 5)])
def test_channel_major_matches_jax_on_the_swapped_dump(channels, rows):
    """K1 reading the channel-major dump in place flags the dump as the JAX
    kernel flags ``swapaxes(v, 0, 1)`` of it (257 flips the right edge's
    fill parity; 5 rows leave a cluster of 4 part empty)."""
    vis, _, _ = rfi_test_data(shape=(channels, rows), seed=12)
    v = jdev.to_planar(vis)  # (channels, rows, 2), channel-major
    got = fp.probe(torch.from_numpy(v).transpose(0, 1), "channel_major")
    want = jpf.flag_transposed(jnp.swapaxes(jnp.asarray(v), 0, 1), bb=rows, interpret=True,
                               width=13, **fp.PARAMS)
    assert got.shape == (rows, channels) and got.any()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), fp.probe_plain(torch.from_numpy(v).transpose(0, 1), "full").numpy())


def test_amp_pairs_clusters_on_cpu():
    """On the CPU K12 at every cluster gives the plain amplitude; a cluster
    outside 1, 2, 4, 8 is refused."""
    vis = torch.from_numpy(np.random.RandomState(4).standard_normal((40, 6, 2)).astype(
        np.float32))  # (channels, rows, 2)
    want = fp.amp_pairs_plain(vis, channel_major=True)
    before = (dict(fp.launches), dict(fp.cluster_launches))
    for g in fp.CLUSTERS:
        assert torch.equal(fp.amp_pairs(vis, channel_major=True, cluster=g), want)
    assert torch.equal(fp.amp_pairs(vis.transpose(0, 1).contiguous()), want)
    assert (fp.launches, fp.cluster_launches) == before  # no kernel on the CPU
    with pytest.raises(ValueError, match="cluster"):
        fp.amp_pairs(vis, channel_major=True, cluster=3)
    with pytest.raises(ValueError, match="cluster"):
        fp.probe(vis.transpose(0, 1), "channel_major", cluster=16)


@pytest.mark.parametrize("width", [7, 13])
def test_exact_variants_equal_k1_and_cpu_takes_the_plain_versions(width):
    vt = torch.from_numpy(_vis_t(300, seed=8))
    before = dict(fp.launches)
    k1 = ff.flag_transposed(vt, width=width, **fp.PARAMS)
    for variant in fp.VARIANTS:
        got = fp.probe(vt, variant, width=width)
        assert torch.equal(got, fp.probe_plain(vt, variant, width=width))
        if variant in fp.EXACT:
            assert torch.equal(got, k1)
        assert set(got.unique().tolist()) <= {0, 1}
    assert fp.launches == before  # no kernel on the CPU


def _rank_rows(channels: int, seed: int) -> np.ndarray:
    """(12, channels) deviations whose |dev| rows hold NaN, +-inf, zeros and
    ties, with targets on +inf and past the non-NaN count (no -0, no
    denormals)."""
    rs = np.random.RandomState(seed)
    d = rs.standard_normal((12, channels)).astype(np.float32)
    d[0, ::7] = np.nan  # NaN counted nowhere, a finite target
    d[1, :channels * 3 // 4] = np.nan  # the target past the non-NaN count
    d[2, :channels * 2 // 3] = np.inf  # the target on +inf
    d[2, -1] = -np.inf
    d[3] = 0.0  # all zeros: the target at the end
    d[4, :channels // 3] = 0.0  # zeros counted out of the median
    d[5] = np.round(d[5] * 2) / 2  # ties: the halfway rule
    d[6] = 1.5  # one value
    d[7, ::2] = 0.0
    d[7, 1::4] = np.nan
    d[8] = np.nan
    d[9, :channels // 2] = -np.inf
    d[10] = (d[10] * 1e30).astype(np.float32)  # wide exponents
    d[11, channels // 2:] = np.inf  # +inf above the target
    return d


def _hold_noise(got, want, *, end_state_free: bool, label: str):
    """Bit for bit; with `end_state_free`, where `got` is the binary search's
    NaN end state, `want` may be +inf or any NaN (an integer-digit search)."""
    got, want = np.asarray(got, np.float32).ravel(), np.asarray(want, np.float32).ravel()
    end = np.isnan(got)
    if end_state_free:
        assert (np.isnan(want[end]) | np.isposinf(want[end])).all(), label
        got, want = got[~end], want[~end]
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32), err_msg=label)


@pytest.mark.parametrize("channels", [1, 2, 13, 256, 1000])
def test_radix_select_plain_matches_the_rank_searches(channels):
    """madnz_radix_plain, bit for bit: against the JAX kernel's binary search
    (``_madnz_band``, rank_radix 1, interpret mode, called as the JAX
    package's test_rank_pair_matches_binary calls it), and, off the end
    state, against its 4-bit rounds and the port's device.madnz at radix 1
    and 4, which count integer digits."""
    from katsdpsigproc_tpu.models.rfi.pallas_flagger import _band_matrix, _madnz_band

    dev = _rank_rows(channels, seed=channels)
    got = fp.madnz_radix_plain(torch.from_numpy(dev)).numpy()
    if channels >= 13:
        assert np.isfinite(got[[0, 4, 5, 6, 10]]).all() and np.isnan(got[[1, 2, 3, 8]]).all()
    absdev = jnp.asarray(np.abs(dev))
    g = _band_matrix(dev.shape[0], 1)
    for radix in (1, 4):
        want = np.asarray(_madnz_band(absdev, g, 1, channels, True, rank_radix=radix))
        _hold_noise(got, want, end_state_free=radix != 1, label=f"JAX rank_radix={radix}")
        want = fp.device.madnz(torch.from_numpy(dev), radix_bits=radix).numpy()
        _hold_noise(got, want, end_state_free=True, label=f"device.madnz radix_bits={radix}")


def test_radix_select_plain_on_denormal_and_negative_zero_rows():
    """XLA on the CPU flushes denormals and rewrites -0, so these rows are held
    to the port's binary search (device.madnz, radix 1) only."""
    rs = np.random.RandomState(3)
    dev = (rs.standard_normal((6, 300)) * 1e-40).astype(np.float32)  # denormals
    dev[1, ::2] = -0.0
    dev[2] = -0.0
    dev[3, ::3] = np.float32(1e-45)  # the smallest denormal, tied
    dev[4] = rs.standard_normal(300).astype(np.float32)
    dev[4, ::2] = -0.0
    dev[5, :100] = np.nan
    assert (np.abs(dev[0]) < np.finfo(np.float32).tiny).all()
    got = fp.madnz_radix_plain(torch.from_numpy(dev)).numpy()
    want = fp.device.madnz(torch.from_numpy(dev), radix_bits=1).numpy()
    _hold_noise(got, want, end_state_free=True, label="device.madnz radix_bits=1")
    assert np.isfinite(got[[0, 1, 3, 4]]).all() and (got[[0, 3]] > 0).all()


def test_radix_select_flags_equal_k1_on_nan_and_inf_rows():
    """Where the noises part (the end state's NaN against device.madnz's
    +inf), neither flags a channel: radix_select's plain version gives K1's
    flags on rows whose target lies on +inf or past the non-NaN count."""
    vt = _vis_t(300, seed=9)
    vt[1, 17, 0] = np.nan  # NaN through the median
    vt[2] = (1.0, 0.0)  # deviations 0, and +inf at every third channel:
    vt[2, ::3, 0] = np.inf  # the target lies on +inf
    vt[3, ::4, 1] = np.nan  # every deviation NaN: the target past the count
    vt = torch.from_numpy(vt)
    dev = fp.device.background_median_filter(
        vt.transpose(0, 1), None, 13, False, fp.device.BackgroundFlags.NONE,
        fast_path=True).transpose(0, 1)
    noise = fp.madnz_radix_plain(dev)
    assert torch.isfinite(noise[[0, 1]]).all() and torch.isnan(noise[[2, 3]]).all()
    assert torch.isposinf(fp.device.madnz(dev)[2])
    want = ff.flag_transposed_plain(vt, **fp.PARAMS)
    np.testing.assert_array_equal(fp.probe(vt, "radix_select").numpy(), want.numpy())
    assert not want[[2, 3]].any() and want[0].any()


def test_variants_and_probes_cover_each_other():
    named = [v for variants in fp.PROBES.values() for v in variants]
    assert sorted(named) == sorted(fp.VARIANTS + ("amp_pairs",))
    assert set(fp.launches) == set(named)
    assert set(fp.EXACT) <= set(fp.VARIANTS)
    # K11, K13, K9 and K12's in-place K1, all on K1's run layout.
    assert fp.VARIANTS == (fp.PROBES["stage_ablate"] + fp.PROBES["rankpair"]
                           + fp.PROBES["rollchain"] + fp.INPLACE)
    assert fp.PROBES["deinterleave"] == ("amp_pairs",) + fp.INPLACE
    assert set(fp.INPLACE) <= set(fp.EXACT) and fp.CLUSTER in fp.CLUSTERS
    assert fp.PROBES["rollchain"] == fp.MEDIANS and set(fp.MEDIANS) <= set(fp.EXACT)
    assert rollchain_ab.RUNS == ("full",) + fp.MEDIANS
    assert list(rankpair_ab.RUNS.values()) == ["full"] + list(fp.RANK_SEARCHES)


def test_probe_validation():
    vt = torch.zeros((2, 64, 2))
    with pytest.raises(ValueError, match="unknown variant"):
        fp.probe(vt, "pair_f32")
    with pytest.raises(ValueError, match="unknown variant"):
        fp.probe_plain(vt, "pair_f32")
    with pytest.raises(ValueError, match="odd"):
        fp.probe(vt, "full", width=12)
    with pytest.raises(ValueError, match="at least width"):
        fp.probe(torch.zeros((2, 12, 2)), "full")
    with pytest.raises(TypeError, match="float32"):
        fp.probe(vt.double(), "full")
    with pytest.raises(ValueError, match="pairs"):
        fp.probe(torch.zeros((2, 64)), "full")
    with pytest.raises(ValueError, match="pairs"):
        fp.amp_pairs(torch.zeros((2, 64, 3)))
    with pytest.raises(ValueError, match="unknown variant"):
        fp.launch_config("binary", 1024)
    with pytest.raises(ValueError, match="unknown variant"):
        fp.max_channels("binary")


def test_build_key_hashes_every_shared_header(tmp_path, monkeypatch):
    """An edit to a header that a source includes gives a new build."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for path in kernels.CSRC_DIR.iterdir():
        (csrc / path.name).write_bytes(path.read_bytes())
    monkeypatch.setattr(kernels, "CSRC_DIR", csrc)
    args = ("flagger_probe", ["flagger_probe.cu"], {"ff_network.h": ff._network_header(13)})
    key = kernels.build_key(*args)
    assert key.startswith("flagger_probe-") and kernels.build_key(*args) == key
    (csrc / "fused_flagger.cu").write_text("// not a source of this library\n")
    assert kernels.build_key(*args) == key
    header = csrc / "ff_device.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    edited = kernels.build_key(*args)
    assert edited != key
    (csrc / "sub").mkdir()
    (csrc / "sub" / "extra.h").write_text("#define X 1\n")
    assert kernels.build_key(*args) not in (key, edited)
    assert kernels.build_key("flagger_probe", ["flagger_probe.cu"],
                             {"ff_network.h": ff._network_header(15)}) != kernels.build_key(*args)


def _small_dump(channels=64, rows=6):
    return torch.from_numpy(jdev.to_planar(common.meerkat_dump(channels, rows)))  # (C, rows, 2)


def test_probe_tools_run_on_cpu_tensors(capsys):
    vis = _small_dump()
    vis_t = vis.transpose(0, 1).contiguous()
    med, stages = stage_ablate.run(vis_t, iters=1, reps=2, card="cpu")
    assert set(med) == set(fp.STAGE_ABLATE) and set(stages) == {"median", "rank", "threshold"}
    assert stages["rank"] == med["full"] - med["no_rank"]
    med, samples = rankpair_ab.run(vis_t, iters=1, reps=1, card="cpu")
    assert set(med) == set(samples) == set(rankpair_ab.RUNS)
    assert set(rollchain_ab.run(vis_t, iters=1, reps=1, card="cpu")) == set(rollchain_ab.RUNS)
    dein = deinterleave_probe.run(vis, iters=1, reps=1, card="cpu")
    assert set(dein) == ({f"K12 g{g}" for g in fp.CLUSTERS}
                         | {f"channel_major g{g}" for g in fp.CLUSTERS}
                         | {"K12 baseline-major", "K5 + baseline-major", "K5 alone", "K1",
                            "K5 + K1"})
    out = capsys.readouterr().out
    assert "parity: all variants == binary (bit-exact)" in out
    assert "parity: all variants == full (bit-exact)" in out
    assert "window_median - full = " in out and "shfl_median - full = " in out
    assert "stage rank" in out and "[cpu]" in out
    assert " - (K5 + K1) = " in out and " - (K1) = " in out and "K12 fastest cluster" in out


def test_parity_mismatch_raises(monkeypatch):
    vis_t = _small_dump().transpose(0, 1).contiguous()
    real = fp.probe

    def wrong(x, variant, **kw):
        out = real(x, variant, **kw)
        return 1 - out if variant == "zeros_fold" else out

    monkeypatch.setattr(fp, "probe", wrong)
    with pytest.raises(RuntimeError, match="PARITY MISMATCH: zeros_fold"):
        rankpair_ab.run(vis_t, iters=1, reps=1)


@pytest.mark.parametrize("tool", [stage_ablate, rankpair_ab, rollchain_ab, deinterleave_probe])
def test_probe_tools_refuse_to_run_without_a_card(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        tool.main(["--channels", "64", "--baselines", "4"])


def test_meerkat_dump_is_the_benchmarks_seed_1_dump():
    rs = np.random.RandomState(seed=1)
    shape = (40, 6)
    want = (rs.standard_normal(shape) + 1j * rs.standard_normal(shape)).astype(np.complex64)
    spikes = rs.random_sample(shape) < 1.0 / 64.0
    want += spikes * (rs.random_sample(shape) * 20.0 + 50.0)
    np.testing.assert_array_equal(common.meerkat_dump(*shape), want)


def test_probes_import_and_run_without_jax():
    """A subprocess where `import jax` fails imports the probe path and runs it."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import numpy as np, torch\n"
        "from katsdpsigproc_tpu_torch.models.rfi import flagger_probe as fp\n"
        "from katsdpsigproc_tpu_torch.utils import profiling\n"
        "from katsdpsigproc_tpu_torch.scripts import (common, deinterleave_probe, rankpair_ab,\n"
        "    rollchain_ab, stage_ablate)\n"
        "rs = np.random.RandomState(0)\n"
        "v = torch.from_numpy(rs.standard_normal((4, 96, 2)).astype(np.float32))\n"
        "v[:, 40] *= 50\n"
        "assert all(bool(fp.probe(v, n)[:, 40].all()) for n in fp.EXACT)\n"
        "assert profiling.time_fn(lambda: fp.amp_pairs(v), iters=2) > 0\n"
        "assert 'katsdpsigproc_tpu' not in sys.modules and 'triton' not in sys.modules\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
