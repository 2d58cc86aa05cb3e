"""The ranks of ``tests/test_torch_parallel.py``: the port's ``parallel`` on gloo.

Each rank is a process started with the ``spawn`` method, joined to its
group through a ``FileStore``; it runs every case of its group in the
same order as every other rank (each case's collectives must line up),
and pickles ``{case: result}`` to ``<out>/rank<r>.pkl``.  A case that
raises stores its traceback as a :class:`CaseError` and the rank goes on.
This module imports no jax: the inputs are made here with numpy, and the
test module makes the same ones for the JAX package and the host oracle.
"""

import os
import pickle
import time
import traceback
from typing import Callable, Dict, List

import numpy as np

from .helpers import rfi_test_data

# The cases' mesh shapes, as tests/test_parallel.py names them.
MESHES = {"mesh_1d": ((8,), ("baseline",)),
          "mesh_2d": ((2, 4), ("baseline", "channel")),
          "mesh_channel": ((1, 8), ("baseline", "channel"))}


class CaseError(str):
    """The traceback of a case that raised on a rank."""


def find_rank_values():
    return np.random.RandomState(seed=1).uniform(0.01, 100.0, (16, 512)).astype(np.float32)


def find_rank_straight_values():
    return np.random.RandomState(seed=21).uniform(0.01, 100.0, (512, 16)).astype(np.float32)


def median_values():
    rs = np.random.RandomState(seed=2)
    values = rs.uniform(0.01, 10.0, (8, 256)).astype(np.float32)
    values[:, rs.random_sample(256) < 0.2] = 0.0
    return values


def percentile_values():
    return np.random.RandomState(seed=3).uniform(0.01, 100.0, (8, 488)).astype(np.float32)


def twod_data(n_bl: int):
    """tests/test_parallel.py::TestShardedTwodflag's cube, with planted RFI."""
    rs = np.random.RandomState(seed=3)
    shape = (32, 96, n_bl)
    data = (rs.standard_normal(shape) + 1j * rs.standard_normal(shape)).astype(np.complex64)
    data[10, :, :] *= 20.0
    flags = np.zeros(shape, np.bool_)
    flags[:, 5, :] = True
    return data, flags


def fused_input(shape, seed):
    """Baseline-major planar (B, C, 2) visibilities and (B, C) uint8 FULL flags."""
    vis, _, input_flags = rfi_test_data(shape=shape, seed=seed)
    planar = np.stack([vis.real, vis.imag], axis=-1).astype(np.float32)
    return np.moveaxis(planar, 0, 1).copy(), input_flags.T.astype(np.uint8).copy()


def draw_fuzz_configs(n):
    """tests/test_parallel_fuzz.py::_draw_configs (seed 20260821)."""
    rs = np.random.RandomState(20260821)
    configs = []
    for i in range(n):
        nb, nc = [(8, 1), (4, 2), (2, 4), (1, 8)][int(rs.randint(4))]
        width = int(rs.choice([9, 13, 17]))
        per_shard = int(rs.randint(width * 4, 160))
        channels = nc * per_shard
        baselines = nb * int(rs.randint(2, 9))
        threshold = str(rs.choice(["simple", "sum"]))
        mode = str(rs.choice(["none", "channel", "full"]))
        configs.append((i, nb, nc, width, channels, baselines, threshold, mode))
    return configs


FUZZ_CONFIGS = draw_fuzz_configs(10)


def fuzz_input(i, channels, baselines, mode):
    """tests/test_parallel_fuzz.py::test_sharded_fuzz's data and flags."""
    rs = np.random.RandomState(2000 + i)
    vis = (rs.standard_normal((channels, baselines))
           + 1j * rs.standard_normal((channels, baselines))).astype(np.complex64)
    spikes = rs.random_sample(vis.shape) < 1 / 48.0
    vis += spikes * (rs.random_sample(vis.shape) * 20.0 + 40.0)
    host_flags = None
    if mode == "channel":
        host_flags = (rs.random_sample(channels) < 0.04).astype(np.uint8)
    elif mode == "full":
        host_flags = (rs.random_sample(vis.shape) < 0.04).astype(np.uint8)
    return vis, host_flags


def multihost_vis():
    """tests/multihost_worker.py's dump: noise with a spike in channel 40."""
    rs = np.random.RandomState(seed=7)
    vis = (rs.standard_normal((128, 8)) + 1j * rs.standard_normal((128, 8))).astype(np.complex64)
    vis[40, :] *= 60.0
    shape = (24, 64, 8)
    cube = (rs.standard_normal(shape) + 1j * rs.standard_normal(shape)).astype(np.complex64)
    cube[5] *= 30.0
    return vis, cube


def _raises(fn) -> str:
    """The type and message of what `fn` raises, or "" if it returns."""
    try:
        fn()
    except Exception as e:  # the case records what it raised; the test asserts its type
        return f"{type(e).__name__}: {e}"
    return ""


def _cases_world8() -> Dict[str, Callable]:
    """The 8-rank group: every case of tests/test_parallel.py, test_parallel_fuzz.py
    and the single-process cases of test_multihost.py."""
    import torch

    from katsdpsigproc_tpu_torch.models.rfi import device as rfi_device, twodflag
    from katsdpsigproc_tpu_torch.parallel import (collectives, flagger as pflagger,
                                                  mesh as pmesh, multihost)

    meshes = {name: pmesh.make_mesh(shape, names, device_type="cpu")
              for name, (shape, names) in MESHES.items()}
    fuzz_meshes = {(nb, nc): pmesh.make_mesh((nb, nc), ("baseline", "channel"),
                                             device_type="cpu")
                   for nb, nc in [(8, 1), (4, 2), (2, 4), (1, 8)]}
    channel = meshes["mesh_channel"]
    group = channel.get_group("channel")
    row_spec, col_spec = (None, "channel"), ("channel", None)

    def np_out(mesh, local, spec):
        return pmesh.gather(mesh, local, spec).cpu().numpy()

    def sharded_flags(mesh, vis, flags=None, **kw):
        fn = pflagger.make_sharded_flagger(mesh, width=13, n_sigma=11.0, **kw)
        args = [pmesh.shard(mesh, vis)]
        if flags is not None:
            spec = ("channel",) if flags.ndim == 1 else pmesh.vis_sharding(mesh)
            args.append(pmesh.shard_with_spec(mesh, flags, spec))
        return np_out(mesh, fn(*args), pmesh.vis_sharding(mesh))

    cases = {
        "find_rank": lambda: np_out(channel, collectives.find_rank_float(
            pmesh.shard_with_spec(channel, find_rank_values(), row_spec), 100, False, group),
            ()),
        "find_rank_straight": lambda: np_out(channel, collectives.find_rank_float(
            pmesh.shard_with_spec(channel, find_rank_straight_values(), col_spec), 100, True,
            group, axis=0), ()),
        "median_non_zero": lambda: np_out(channel, collectives.median_non_zero(
            pmesh.shard_with_spec(channel, median_values(), row_spec), 256, group), ()),
        "percentile5": lambda: np_out(channel, collectives.percentile5(
            pmesh.shard_with_spec(channel, percentile_values(), row_spec), 488, group), ()),
        "halo_rows": lambda: np_out(channel, collectives.halo_exchange(
            pmesh.shard_with_spec(channel, np.arange(64, dtype=np.float32).reshape(64, 1),
                                  col_spec), 2, group, float("nan"), axis=0), col_spec),
    }
    vis5 = rfi_test_data(shape=(256, 64), seed=5)[0]
    for name, mesh in meshes.items():
        for threshold in ("simple", "sum"):
            cases[f"flagger-{name}-{threshold}"] = (
                lambda mesh=mesh, threshold=threshold: sharded_flags(mesh, vis5,
                                                                     threshold=threshold))
        cases[f"baseline_block-{name}"] = lambda mesh=mesh: (
            sharded_flags(mesh, vis5, baseline_block=8), sharded_flags(mesh, vis5))
    mesh_1d, mesh_2d = meshes["mesh_1d"], meshes["mesh_2d"]

    def channel_flags():
        vis, _, flags = rfi_test_data(shape=(256, 64), seed=6)
        return sharded_flags(mesh_2d, vis, flags[:, 0],
                             use_flags=rfi_device.BackgroundFlags.CHANNEL, threshold="simple")

    def full_flags():
        vis, _, flags = rfi_test_data(shape=(256, 64), seed=8)
        return sharded_flags(mesh_2d, vis, flags, use_flags=rfi_device.BackgroundFlags.FULL,
                             threshold="sum")

    cases["channel_flags"] = channel_flags
    cases["full_flags"] = full_flags

    def planar():
        vis = rfi_test_data(shape=(256, 64), seed=9)[0]
        return (sharded_flags(mesh_2d, vis, threshold="sum"),
                sharded_flags(mesh_2d, rfi_device.to_planar(vis), threshold="sum"))

    cases["planar_input"] = planar
    cases["amplitude_input"] = lambda: sharded_flags(
        mesh_1d, np.abs(rfi_test_data(shape=(256, 64), seed=10)[0]).astype(np.float32),
        is_amplitude=True, threshold="simple")

    def flag_arg_validation():
        fn = pflagger.make_sharded_flagger(mesh_1d)
        vis = pmesh.shard(mesh_1d, np.zeros((16, 8), np.complex64))
        with_flags = pflagger.make_sharded_flagger(
            mesh_1d, use_flags=rfi_device.BackgroundFlags.FULL)
        return (_raises(lambda: fn(vis, torch.zeros(16, dtype=torch.uint8))),
                _raises(lambda: with_flags(vis)))

    cases["flag_arg_validation"] = flag_arg_validation

    def fused(shape, seed, with_flags, **kw):
        vis_t, flags_t = fused_input(shape, seed)
        fn = pflagger.make_sharded_fused_flagger(mesh_1d, width=13, n_sigma=11.0, bb=4, **kw)
        spec = ("baseline",)
        args = [pmesh.shard_with_spec(mesh_1d, vis_t, spec)]
        if with_flags:
            args.append(pmesh.shard_with_spec(mesh_1d, flags_t, spec))
        return np_out(mesh_1d, fn(*args), spec)

    cases["fused_matches_host_oracle"] = lambda: (fused((256, 32), 31, False),
                                                  fused((256, 32), 31, True))

    def fused_divisibility():
        fn = pflagger.make_sharded_fused_flagger(mesh_1d, bb=4, interpret=True)
        return (_raises(lambda: pmesh.shard_with_spec(
                    mesh_1d, np.zeros((28, 256, 2), np.float32), ("baseline",))),
                _raises(lambda: fn(pmesh.shard_with_spec(
                    mesh_1d, np.zeros((24, 256, 2), np.float32), ("baseline",)))),
                _raises(lambda: pflagger.make_sharded_fused_flagger(
                    mesh_1d, axis_name="channel")))

    cases["fused_validates_divisibility"] = fused_divisibility
    cases["fused_dma_matches_grid"] = lambda: (fused((128, 32), 33, False, pipeline="dma"),
                                               fused((128, 32), 33, False))
    for n_bl in (16, 11):
        cases[f"twod-{n_bl}"] = lambda n_bl=n_bl: twodflag.SumThresholdFlagger(
            freq_chunks=4).get_flags_sharded(*twod_data(n_bl), mesh_1d)

    for i, nb, nc, width, channels, baselines, threshold, mode in FUZZ_CONFIGS:
        def fuzz(i=i, nb=nb, nc=nc, width=width, channels=channels, baselines=baselines,
                 threshold=threshold, mode=mode):
            mesh = fuzz_meshes[(nb, nc)]
            vis, host_flags = fuzz_input(i, channels, baselines, mode)
            use_flags = {"none": rfi_device.BackgroundFlags.NONE,
                         "channel": rfi_device.BackgroundFlags.CHANNEL,
                         "full": rfi_device.BackgroundFlags.FULL}[mode]
            fn = pflagger.make_sharded_flagger(mesh, width=width, n_sigma=11.0,
                                               threshold=threshold, use_flags=use_flags)
            args = [pmesh.shard(mesh, vis)]
            if host_flags is not None:
                spec = ("channel",) if mode == "channel" else pmesh.vis_sharding(mesh)
                args.append(pmesh.shard_with_spec(mesh, host_flags, spec))
            return np_out(mesh, fn(*args), pmesh.vis_sharding(mesh))

        cases[f"fuzz-{i}"] = fuzz

    def pod_mesh_shapes():
        m = multihost.pod_mesh(device_type="cpu")
        m2 = multihost.pod_mesh(channel_shards=2, device_type="cpu")
        return (tuple(m.shape), tuple(m2.shape), m2.mesh_dim_names,
                _raises(lambda: multihost.pod_mesh(baseline_shards=3, channel_shards=2,
                                                   device_type="cpu")),
                _raises(lambda: pmesh.make_mesh((16,), device_type="cpu")))

    cases["pod_mesh_shapes"] = pod_mesh_shapes
    cases["process_summary"] = multihost.process_summary
    return cases


def _cases_world2(store: str) -> Dict[str, Callable]:
    """tests/multihost_worker.py at two ranks: meshes across the process boundary."""
    import torch.distributed as dist

    from katsdpsigproc_tpu_torch.models.rfi import twodflag
    from katsdpsigproc_tpu_torch.parallel import flagger as pflagger, mesh as pmesh, multihost

    def two_process():
        vis, cube = multihost_vis()
        multihost.initialize(f"file://{store}", 2, dist.get_rank(), backend="gloo")  # idempotent
        out = {"summary": multihost.process_summary(), "world": dist.get_world_size()}
        # Baselines across the ranks, then the channel axis (the rank search
        # and both halos) across them.
        for key, (nb, nc) in (("baseline", (2, 1)), ("channel", (1, 2))):
            m = multihost.pod_mesh(baseline_shards=nb, channel_shards=nc, device_type="cpu")
            fn = pflagger.make_sharded_flagger(m, width=13, n_sigma=11.0, threshold="sum")
            out[key] = pmesh.gather(m, fn(pmesh.shard(m, vis)),
                                    pmesh.vis_sharding(m)).cpu().numpy()
        m1 = multihost.pod_mesh(device_type="cpu")
        flagger2d = twodflag.SumThresholdFlagger(freq_chunks=4)
        in_flags = np.zeros(cube.shape, np.bool_)
        out["twod"] = flagger2d.get_flags_sharded(cube, in_flags, m1)
        out["twod_single"] = flagger2d.get_flags(cube, in_flags, device="cpu")
        return out

    return {"two_process": two_process}


def rank_main(rank: int, world: int, group_name: str, out_dir: str) -> None:
    """One rank: join the group, run its cases, pickle the results."""
    try:
        import torch
        import torch.distributed as dist

        torch.set_num_threads(1)
        store = os.path.join(out_dir, "store")
        t0 = time.perf_counter()
        if group_name == "world8":
            dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                    world_size=world)
            cases = _cases_world8()
        else:
            from katsdpsigproc_tpu_torch.parallel import multihost

            multihost.initialize(f"file://{store}", world, rank, backend="gloo")
            cases = _cases_world2(store)
        results = {}
        for name, case in cases.items():
            try:
                results[name] = case()
            except Exception:  # recorded for the test to report; the other cases go on
                results[name] = CaseError(traceback.format_exc())
        results["_seconds"] = time.perf_counter() - t0
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


class RankGroup:
    """`world` spawned ranks of `group_name`, started at once, joined on first use."""

    def __init__(self, world: int, group_name: str, out_dir: str, timeout: float):
        import multiprocessing

        self.world, self.out_dir, self.timeout = world, out_dir, timeout
        ctx = multiprocessing.get_context("spawn")
        self.procs = [ctx.Process(target=rank_main, args=(r, world, group_name, out_dir),
                                  daemon=True) for r in range(world)]
        self.started = time.monotonic()
        for p in self.procs:
            p.start()
        self._results = None

    def results(self) -> List[dict]:
        """Each rank's ``{case: result}``; raises if a rank hung or failed."""
        if self._results is None:
            deadline = self.started + self.timeout
            for p in self.procs:
                p.join(max(0.0, deadline - time.monotonic()))
            hung = [r for r, p in enumerate(self.procs) if p.is_alive()]
            self.close()
            if hung:
                raise AssertionError(f"ranks {hung} of {self.world} still running after "
                                     f"{self.timeout} s")
            errors = []
            for r, p in enumerate(self.procs):
                err = os.path.join(self.out_dir, f"rank{r}.err")
                if p.exitcode != 0:
                    text = open(err).read() if os.path.exists(err) else ""
                    errors.append(f"rank {r} exited {p.exitcode}:\n{text}")
            if errors:
                raise AssertionError("\n".join(errors))
            self._results = []
            for r in range(self.world):
                with open(os.path.join(self.out_dir, f"rank{r}.pkl"), "rb") as f:
                    self._results.append(pickle.load(f))
        return self._results

    def close(self) -> None:
        """Stop any rank still running."""
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join(10)

    def case(self, name: str) -> list:
        """`name`'s result on every rank; fails on a rank where it raised."""
        values = [results[name] for results in self.results()]
        for r, value in enumerate(values):
            if isinstance(value, CaseError):
                raise AssertionError(f"case {name} raised on rank {r}:\n{value}")
        return values
