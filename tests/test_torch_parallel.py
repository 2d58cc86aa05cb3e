"""The port's ``parallel`` on gloo ranks, against the JAX package's on the
8 virtual CPU devices that ``tests/conftest.py`` gives this process.

Every case of ``tests/test_parallel.py``, ``tests/test_parallel_fuzz.py``
and ``tests/test_multihost.py`` has its counterpart here.  The port's
cases run in groups of spawned ranks (``tests/torch_parallel_worker.py``):
one group of 8 ranks for every mesh shape ((8,), (2, 4), (1, 8) and the
fuzz draws' factorizations), one of 2 ranks for the two-process run.
Each group starts once per module and runs all its cases; each join has
its own time limit.  The same numpy inputs go through the JAX functions
on the same mesh shapes.  Tolerance: exact.  Collective results are held
to JAX's bit for bit, masks flag for flag to JAX's and to the numpy host
oracle's, and every rank's gathered result must be the same.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.distributed as dist
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

from katsdpsigproc_tpu.models.rfi import device as jdev, host as rfi_host, twodflag as jtwod
from katsdpsigproc_tpu.ops import percentile as jpercentile, rank as jrank
from katsdpsigproc_tpu.parallel import (collectives as jcoll, flagger as jflagger,
                                        mesh as jmesh, multihost as jmultihost)
from katsdpsigproc_tpu_torch.models.rfi import twodflag
from katsdpsigproc_tpu_torch.parallel import multihost

from . import torch_parallel_worker as worker
from .helpers import rfi_test_data

CHANNEL = jmesh.CHANNEL_AXIS


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    group = worker.RankGroup(2, "world2", str(tmp_path_factory.mktemp("world2")), timeout=240)
    yield group
    group.close()


@pytest.fixture(scope="module")
def world8(tmp_path_factory, world2):
    """The 8-rank group, started after the 2-rank one so that both run at once."""
    group = worker.RankGroup(8, "world8", str(tmp_path_factory.mktemp("world8")), timeout=240)
    yield group
    group.close()


def _result(group, name):
    """`name`'s result, the same on every rank."""
    values = group.case(name)
    for value in values[1:]:
        np.testing.assert_equal(value, values[0])
    return values[0]


def _bits_equal(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def _jax_mesh(name):
    shape, names = worker.MESHES[name]
    return jmesh.make_mesh(shape, names)


def _jax_shard_map(mesh, fn, in_spec, out_spec, values):
    return np.asarray(jax.jit(shard_map(fn, mesh=mesh, in_specs=in_spec, out_specs=out_spec,
                                        check_rep=False))(jnp.asarray(values)))


def _host_flagger(width=13, threshold="sum", amplitudes=False):
    host_threshold = (rfi_host.ThresholdSimpleHost(11.0) if threshold == "simple"
                      else rfi_host.ThresholdSumHost(11.0))
    return rfi_host.FlaggerHost(rfi_host.BackgroundMedianFilterHost(width, amplitudes=amplitudes),
                                rfi_host.NoiseEstMADHost(), host_threshold)


def _mask_equal(got, *wants):
    for want in wants:
        want = np.asarray(want)
        assert got.shape == want.shape, (got.shape, want.shape)
        np.testing.assert_array_equal(got, want)


# -- collectives (tests/test_parallel.py::TestCollectiveRank, TestHaloExchange) --


def test_find_rank_matches_local(world8):
    values = worker.find_rank_values()
    got = _result(world8, "find_rank")
    want = _jax_shard_map(_jax_mesh("mesh_channel"),
                          lambda v: jcoll.find_rank_float(v, 100, False, CHANNEL),
                          P(None, CHANNEL), P(None), values)
    _bits_equal(got, want)
    _bits_equal(got, jrank.find_rank_float(jnp.asarray(values), 100, False))
    np.testing.assert_equal(got, np.sort(values, axis=-1)[:, 100])


def test_find_rank_straight_layout(world8):
    values = worker.find_rank_straight_values()
    got = _result(world8, "find_rank_straight")
    want = _jax_shard_map(_jax_mesh("mesh_channel"),
                          lambda v: jcoll.find_rank_float(v, 100, True, CHANNEL, axis=0),
                          P(CHANNEL, None), P(None), values)
    _bits_equal(got, want)
    _bits_equal(got, jrank.find_rank_float(jnp.asarray(values), 100, True, axis=0))


def test_median_non_zero_matches_local(world8):
    values = worker.median_values()
    got = _result(world8, "median_non_zero")
    want = _jax_shard_map(_jax_mesh("mesh_channel"),
                          lambda v: jcoll.median_non_zero(v, 256, CHANNEL),
                          P(None, CHANNEL), P(None), values)
    _bits_equal(got, want)
    for i in range(values.shape[0]):
        nz = values[i][values[i] > 0]
        np.testing.assert_allclose(got[i], np.median(nz), rtol=1e-6)


def test_percentile5_matches_local(world8):
    values = worker.percentile_values()
    got = _result(world8, "percentile5")
    want = _jax_shard_map(_jax_mesh("mesh_channel"),
                          lambda v: jcoll.percentile5(v, 488, CHANNEL),
                          P(None, CHANNEL), P(None, None), values)
    _bits_equal(got, want)
    _bits_equal(got, jpercentile.percentile5(jnp.asarray(values)))


def test_halo_rows(world8):
    x = np.arange(64, dtype=np.float32).reshape(64, 1)
    got = _result(world8, "halo_rows")  # (8 shards x 12 rows, 1)
    want = _jax_shard_map(_jax_mesh("mesh_channel"),
                          lambda v: jcoll.halo_exchange(v, 2, CHANNEL, jnp.nan, axis=0),
                          P(CHANNEL, None), P(CHANNEL, None), x)
    _bits_equal(got, want)
    blocks = got.reshape(8, 12, 1)
    # First shard: NaN pad on the left, rows 0..7, then neighbour rows 8, 9.
    assert np.isnan(blocks[0, :2]).all()
    np.testing.assert_equal(blocks[0, 2:10, 0], np.arange(8))
    np.testing.assert_equal(blocks[0, 10:, 0], [8, 9])
    # Middle shard 3: left halo 22, 23, then 24..31, then 32, 33.
    np.testing.assert_equal(blocks[3, :, 0], np.arange(22, 34))
    # Last shard: NaN pad on the right.
    assert np.isnan(blocks[7, -2:]).all()
    np.testing.assert_equal(blocks[7, :10, 0], np.arange(54, 64))


# -- the stage flagger (tests/test_parallel.py::TestShardedFlagger) -------------


def _jax_flags(mesh, *args, **kw):
    fn = jflagger.make_sharded_flagger(mesh, n_sigma=11.0, **kw)
    return np.asarray(fn(*(jnp.asarray(a) for a in args)))


@pytest.mark.parametrize("mesh_name", ["mesh_1d", "mesh_2d", "mesh_channel"])
@pytest.mark.parametrize("threshold", ["simple", "sum"])
def test_matches_host(world8, mesh_name, threshold):
    vis, _, _ = rfi_test_data(shape=(256, 64), seed=5)
    got = _result(world8, f"flagger-{mesh_name}-{threshold}")
    _mask_equal(got, _jax_flags(_jax_mesh(mesh_name), vis, width=13, threshold=threshold),
                _host_flagger(threshold=threshold)(vis))


@pytest.mark.parametrize("mesh_name", ["mesh_1d", "mesh_2d", "mesh_channel"])
def test_baseline_block_matches_unblocked(world8, mesh_name):
    vis, _, _ = rfi_test_data(shape=(256, 64), seed=5)
    blocked, plain = _result(world8, f"baseline_block-{mesh_name}")
    want = _jax_flags(_jax_mesh(mesh_name), vis, width=13, baseline_block=8)
    _mask_equal(blocked, plain, want)


def test_with_channel_flags(world8):
    vis, _, input_flags = rfi_test_data(shape=(256, 64), seed=6)
    got = _result(world8, "channel_flags")
    want = _jax_flags(_jax_mesh("mesh_2d"), vis, input_flags[:, 0], width=13,
                      use_flags=jdev.BackgroundFlags.CHANNEL, threshold="simple")
    _mask_equal(got, want, _host_flagger(threshold="simple")(vis, input_flags[:, 0]))


def test_with_full_flags(world8):
    vis, _, input_flags = rfi_test_data(shape=(256, 64), seed=8)
    got = _result(world8, "full_flags")
    want = _jax_flags(_jax_mesh("mesh_2d"), vis, input_flags, width=13,
                      use_flags=jdev.BackgroundFlags.FULL, threshold="sum")
    _mask_equal(got, want, _host_flagger()(vis, input_flags))


def test_planar_input(world8):
    vis, _, _ = rfi_test_data(shape=(256, 64), seed=9)
    complex_flags, planar_flags = _result(world8, "planar_input")
    _mask_equal(planar_flags, complex_flags,
                _jax_flags(_jax_mesh("mesh_2d"), jdev.to_planar(vis), width=13),
                _host_flagger()(vis))


def test_amplitude_input(world8):
    vis, _, _ = rfi_test_data(shape=(256, 64), seed=10)
    amp = np.abs(vis).astype(np.float32)
    got = _result(world8, "amplitude_input")
    want = _jax_flags(_jax_mesh("mesh_1d"), amp, width=13, is_amplitude=True,
                      threshold="simple")
    _mask_equal(got, want, _host_flagger(threshold="simple", amplitudes=True)(amp))


def test_flag_arg_validation(world8):
    unexpected, missing = _result(world8, "flag_arg_validation")
    assert unexpected.startswith("TypeError: flags were provided"), unexpected
    assert missing.startswith("TypeError: flags were expected"), missing
    fn = jflagger.make_sharded_flagger(_jax_mesh("mesh_1d"))
    with pytest.raises(TypeError):
        fn(jnp.zeros((16, 8), jnp.complex64), jnp.zeros(16, jnp.uint8))


# -- get_flags_sharded (tests/test_parallel.py::TestShardedTwodflag) ------------


@pytest.mark.parametrize("n_bl", [16, 11])
def test_twodflag_sharded_matches_unsharded(world8, n_bl):
    """16 baselines split evenly over 8 ranks; 11 need the pad to 16."""
    data, flags = worker.twod_data(n_bl)
    got = _result(world8, f"twod-{n_bl}")
    port = twodflag.SumThresholdFlagger(freq_chunks=4).get_flags(data, flags, device="cpu")
    want = jtwod.SumThresholdFlagger(freq_chunks=4).get_flags(data, flags)
    assert got.dtype == np.bool_
    _mask_equal(got, port, want)


def test_twodflag_sharded_validates_shapes():
    flagger = twodflag.SumThresholdFlagger()
    with pytest.raises(ValueError, match="Shape mismatch"):
        flagger.get_flags_sharded(np.zeros((4, 8, 2)), np.zeros((4, 8, 3), bool), None)
    with pytest.raises(ValueError, match="wrong number of dimensions"):
        flagger.get_flags_sharded(np.zeros((4, 8)), np.zeros((4, 8), bool), None)


# -- the fused flagger (tests/test_parallel.py::TestShardedFusedFlagger) --------


def _jax_fused(vis_t, flags_t=None, **kw):
    fn = jflagger.make_sharded_fused_flagger(_jax_mesh("mesh_1d"), width=13, n_sigma=11.0, bb=4,
                                             interpret=True, **kw)
    args = (jnp.asarray(vis_t),) + (() if flags_t is None else (jnp.asarray(flags_t),))
    return np.asarray(fn(*args))


def test_fused_matches_host_oracle(world8):
    vis, _, input_flags = rfi_test_data(shape=(256, 32), seed=31)
    vis_t, flags_t = worker.fused_input((256, 32), 31)
    plain, with_flags = _result(world8, "fused_matches_host_oracle")
    _mask_equal(plain, _jax_fused(vis_t), _host_flagger()(vis).T)
    _mask_equal(with_flags, _jax_fused(vis_t, flags_t), _host_flagger()(vis, input_flags).T)


def test_fused_validates_divisibility(world8):
    indivisible, not_by_bb, no_axis = _result(world8, "fused_validates_divisibility")
    assert indivisible.startswith("ValueError") and "divide" in indivisible, indivisible
    assert not_by_bb == "ValueError: baselines (24) must divide by shards*bb (8*4)", not_by_bb
    assert no_axis == "ValueError: mesh must name a 'channel' axis", no_axis
    fn = jflagger.make_sharded_fused_flagger(_jax_mesh("mesh_1d"), bb=4, interpret=True)
    with pytest.raises(ValueError, match="divide"):
        fn(jnp.zeros((24, 256, 2), jnp.float32))


def test_fused_dma_pipeline_matches_grid(world8):
    vis, _, _ = rfi_test_data(shape=(128, 32), seed=33)
    vis_t, _ = worker.fused_input((128, 32), 33)
    dma, grid = _result(world8, "fused_dma_matches_grid")
    _mask_equal(dma, grid, _jax_fused(vis_t, pipeline="dma"), _host_flagger()(vis).T)


# -- the seeded draws of tests/test_parallel_fuzz.py ----------------------------


@pytest.mark.parametrize("i,nb,nc,width,channels,baselines,threshold,mode",
                         worker.FUZZ_CONFIGS)
def test_sharded_fuzz(world8, i, nb, nc, width, channels, baselines, threshold, mode):
    vis, host_flags = worker.fuzz_input(i, channels, baselines, mode)
    got = _result(world8, f"fuzz-{i}")
    use_flags = {"none": jdev.BackgroundFlags.NONE, "channel": jdev.BackgroundFlags.CHANNEL,
                 "full": jdev.BackgroundFlags.FULL}[mode]
    mesh = jmesh.make_mesh((nb, nc), (jmesh.BASELINE_AXIS, CHANNEL))
    args = (vis,) if host_flags is None else (vis, host_flags)
    want = _jax_flags(mesh, *args, width=width, threshold=threshold, use_flags=use_flags)
    expected = _host_flagger(width, threshold)(vis, host_flags)
    _mask_equal(got, want, expected)
    assert expected.any(), "planted spikes produced no flags"


# -- multihost (tests/test_multihost.py) -----------------------------------------


def test_initialize_single_host_noop():
    multihost.initialize(num_processes=1)  # must not raise
    assert not dist.is_initialized()


def test_pod_mesh_shapes(world8):
    shape, shape2, names, wrong, too_large = _result(world8, "pod_mesh_shapes")
    m, m2 = jmultihost.pod_mesh(), jmultihost.pod_mesh(channel_shards=2)
    assert shape == (m.shape[jmesh.BASELINE_AXIS], m.shape[CHANNEL]) == (8, 1)
    assert shape2 == (m2.shape[jmesh.BASELINE_AXIS], m2.shape[CHANNEL]) == (4, 2)
    assert names == tuple(m2.axis_names) == ("baseline", "channel")
    assert wrong == "ValueError: mesh 3x2 != device count 8", wrong
    assert too_large == "ValueError: mesh shape (16,) needs 16 devices, have 8", too_large
    with pytest.raises(ValueError):
        jmultihost.pod_mesh(baseline_shards=3, channel_shards=2)


def test_process_summary(world8):
    s = multihost.process_summary()
    assert "process 0/1" in s and "process 0/1" in jmultihost.process_summary()
    for r, summary in enumerate(world8.case("process_summary")):
        assert summary == f"process {r}/8, 1 local of 8 devices", summary


def test_two_process_distributed(world2):
    """Two gloo ranks: a (2, 1) and a (1, 2) mesh across the process boundary
    (the channel mesh puts the rank search and both halos across it), the
    masks against JAX on the same mesh shapes and the host oracle, and the
    2-D flagger sharded over both ranks against get_flags."""
    vis, cube = worker.multihost_vis()
    expected = _host_flagger()(np.abs(vis))
    assert expected.any(), "planted spike produced no flags"
    results = world2.case("two_process")
    for r, out in enumerate(results):
        assert out["world"] == 2 and out["summary"].startswith(f"process {r}/2"), out["summary"]
        for key, shape in (("baseline", (2, 1)), ("channel", (1, 2))):
            mesh = jmesh.make_mesh(shape, (jmesh.BASELINE_AXIS, CHANNEL))
            _mask_equal(out[key], _jax_flags(mesh, vis, width=13), expected)
        _mask_equal(out["twod"], out["twod_single"])
        mismatches = int((out["twod"] != out["twod_single"]).sum())
        print(f"process {r}: OK ({int(expected.sum())} flags, 0 mismatches; "
              f"2-D {mismatches} mismatches)")
