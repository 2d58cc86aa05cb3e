"""The port's region copies (katsdpsigproc_tpu_torch.utils.regions) against the
JAX package's, on the CPU.

Every case of ``tests/test_regions.py``, the fuzz against numpy included:
the same seeded numpy inputs go through ``katsdpsigproc_tpu.utils.regions``
and the port, and the results must be equal bit for bit to each other and
to numpy's slice assignment.  The port writes into its destination in
place and returns it; the JAX functions return a new array.  Error cases
must raise the same exception type in both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from katsdpsigproc_tpu.utils import regions as jregions
from katsdpsigproc_tpu_torch.utils import regions


def _bits(a):
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[a.itemsize])


def _assert_bits_equal(want, got):
    want, got = np.asarray(want), np.asarray(got)
    assert want.dtype == got.dtype and want.shape == got.shape
    np.testing.assert_array_equal(_bits(want), _bits(got))


def _roundtrip(src_shape, dest_shape, src_region, dest_region, dtype=np.float32):
    """tests/test_regions.py::_roundtrip on both packages: copy, set and get."""
    rs = np.random.RandomState(seed=42)
    h_src = rs.uniform(size=src_shape).astype(dtype)
    h_dest = rs.uniform(size=dest_shape).astype(dtype)

    expected = h_dest.copy()
    src_index, _ = regions.canonical_region(src_region, src_shape)
    dest_index, _ = regions.canonical_region(dest_region, dest_shape)
    expected[dest_index] = h_src[src_index].reshape(expected[dest_index].shape)

    # copy_region (device -> device), in place on the port's side
    dest = torch.from_numpy(h_dest.copy())
    out = regions.copy_region(torch.from_numpy(h_src), dest, src_region, dest_region)
    assert out is dest
    want = jregions.copy_region(jnp.asarray(h_src), jnp.asarray(h_dest), src_region,
                                dest_region)
    _assert_bits_equal(want, out.numpy())
    _assert_bits_equal(expected, out.numpy())

    # set_region (host -> device)
    dest = torch.from_numpy(h_dest.copy())
    assert regions.set_region(dest, h_src, dest_region, src_region) is dest
    want = jregions.set_region(jnp.asarray(h_dest), h_src, dest_region, src_region)
    _assert_bits_equal(want, dest.numpy())
    _assert_bits_equal(expected, dest.numpy())

    # get_region (device -> host)
    h_out, j_out = h_dest.copy(), h_dest.copy()
    regions.get_region(torch.from_numpy(h_src), h_out, src_region, dest_region)
    jregions.get_region(jnp.asarray(h_src), j_out, src_region, dest_region)
    _assert_bits_equal(j_out, h_out)
    _assert_bits_equal(expected, h_out)


_CASES = {
    "4d": ((10, 12, 14, 16), (5, 6, 7, 8), np.s_[2:7, 3:9, 4:11, 5:13],
           np.s_[0:5, 0:6, 0:7, 0:8]),
    "0d": ((), (), (), ()),
    "1d": ((10,), (10,), np.s_[2:6], np.s_[4:8]),
    "2d": ((10, 12), (12, 10), np.s_[2:6, 3:9], np.s_[4:8, 1:7]),
    # Fewer indices than axes selects the whole trailing axes.
    "missing_axes": ((10, 12), (10, 12), np.s_[2:3], np.s_[4:5]),
    "int_collapse": ((10, 12), (12,), np.s_[3], np.s_[:]),
    "newaxis": ((10,), (3, 10), np.s_[np.newaxis, 2:8], np.s_[1:2, 0:6]),
    "negative_index": ((10, 12), (12,), np.s_[-1], np.s_[:]),
    "strided": ((10,), (3,), np.s_[0:9:3], np.s_[:]),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_copy_region(case):
    _roundtrip(*_CASES[case])


@pytest.mark.parametrize("dtype", [np.uint8, np.int32, np.float16, np.complex64, np.bool_])
def test_copy_region_dtypes(dtype):
    _roundtrip((10, 12), (12, 10), np.s_[2:6, 3:9:2], np.s_[4:8, 1:4], dtype=dtype)


def test_canonical_region_strided():
    # The reference's truncating length (stop - start) // stride.
    for canonical in (regions.canonical_region, jregions.canonical_region):
        index, sel = canonical(np.s_[0:10:3], (10,))
        assert sel == (3,)
        assert index == (slice(0, 9, 3),)


@pytest.mark.parametrize("region,shape", [
    (np.s_[0:10:3], (10,)), (np.s_[3, np.newaxis, 1:9:4], (10, 12, 5)), (np.s_[-2], (7, 3)),
    (np.s_[np.int64(4), 2:], (6, 6)), ((), (4, 5)), ((slice(2, 3),), (4, 5)),
])
def test_canonical_region_matches_jax(region, shape):
    assert regions.canonical_region(region, shape) == jregions.canonical_region(region, shape)


@pytest.mark.parametrize("error,src_region,dest_region", [
    (IndexError, np.s_[3, 4], np.s_[5, 6]),  # too many axes
    (IndexError, np.s_[5], np.s_[10]),  # out-of-range single index
    (IndexError, np.s_[10:12], np.s_[8:10]),  # out-of-range slice clamps to empty
    (IndexError, np.s_[2:2], np.s_[3:3]),  # empty slice
    (IndexError, np.s_[3:0:-1], np.s_[4:1:-1]),  # negative stride
    (ValueError, np.s_[0:4], np.s_[0:5]),  # shapes differ between the regions
    (TypeError, np.s_[0:4.0], np.s_[0:4]),  # invalid index type
    (TypeError, np.s_[True], np.s_[0]),  # a bool is not an index
])
def test_copy_region_errors(error, src_region, dest_region):
    h = np.arange(10, dtype=np.float32)
    with pytest.raises(error):
        _roundtrip((10,), (10,), src_region, dest_region)
    for call in (lambda: jregions.copy_region(jnp.asarray(h), jnp.asarray(h), src_region,
                                              dest_region),
                 lambda: regions.copy_region(torch.from_numpy(h), torch.from_numpy(h.copy()),
                                             src_region, dest_region),
                 lambda: regions.copy_region_donated(torch.from_numpy(h),
                                                     torch.from_numpy(h.copy()),
                                                     src_region, dest_region),
                 lambda: regions.set_region(torch.from_numpy(h), h, src_region, dest_region),
                 lambda: regions.get_region(torch.from_numpy(h), h.copy(), src_region,
                                            dest_region)):
        with pytest.raises(error):
            call()


def test_invalid_index_type():
    for canonical in (regions.canonical_region, jregions.canonical_region):
        with pytest.raises(TypeError):
            canonical(np.s_[0:4, "x"], (10, 10))


def test_dtype_mismatch():
    with pytest.raises(TypeError):
        jregions.copy_region(jnp.zeros(4, jnp.float32), jnp.zeros(4, jnp.int32),
                             np.s_[:], np.s_[:])
    with pytest.raises(TypeError, match="dtype mismatch"):
        regions.copy_region(torch.zeros(4), torch.zeros(4, dtype=torch.int32),
                            np.s_[:], np.s_[:])
    # A numpy array is compared as the torch dtype it maps to.
    with pytest.raises(TypeError, match="dtype mismatch"):
        regions.set_region(torch.zeros(4), np.zeros(4, np.float64), np.s_[:], np.s_[:])
    with pytest.raises(TypeError, match="dtype mismatch"):
        regions.get_region(torch.zeros(4), np.zeros(4, np.int32), np.s_[:], np.s_[:])
    with pytest.raises(TypeError):
        regions.set_region(torch.zeros(4), np.zeros(4, object), np.s_[:], np.s_[:])
    regions.set_region(torch.zeros(4), np.zeros(4, np.float32), np.s_[:], np.s_[:])


def test_tensors_are_required():
    with pytest.raises(TypeError, match="torch.Tensor"):
        regions.copy_region(np.zeros(4, np.float32), torch.zeros(4), np.s_[:], np.s_[:])
    with pytest.raises(TypeError, match="torch.Tensor"):
        regions.set_region(np.zeros(4, np.float32), np.zeros(4, np.float32), np.s_[:],
                           np.s_[:])


def _random_region(rs, shape, sel_shape_out):
    """tests/test_regions.py::test_fuzz_vs_numpy_semantics's region generator."""
    region = []
    for dim in shape:
        kind = rs.choice(["slice", "int", "full", "stop"])
        if kind == "int":
            region.append(int(rs.randint(dim)))
        elif kind == "full":
            region.append(np.s_[:])
            sel_shape_out.append(dim)
        elif kind == "stop":
            n = int(rs.randint(1, dim + 1))
            start = int(rs.randint(0, dim - n + 1))
            region.append(slice(start, start + n))
            sel_shape_out.append(n)
        else:
            stride = int(rs.randint(1, min(3, dim) + 1))
            n = int(rs.randint(1, dim // stride + 1))
            start = int(rs.randint(0, dim - n * stride + 1))
            region.append(slice(start, start + n * stride, stride))
            sel_shape_out.append(n)
    if rs.rand() < 0.3 and region and isinstance(region[-1], slice):
        region.pop()  # implied trailing axis selects the whole axis
        sel_shape_out[-1] = shape[-1]
    return tuple(region)


def test_fuzz_vs_numpy_semantics():
    """100 random region pairs (the JAX test's seed-11 sequence): the port's
    copy_region, set_region and get_region, JAX's copy_region and numpy's
    slice assignment agree bit for bit.

    Slices have (stop - start) % stride == 0, so the reference's truncating
    length coincides with numpy's; ints, newaxis-free regions and implied
    trailing axes are mixed in.
    """
    rs = np.random.RandomState(seed=11)
    for trial in range(100):
        ndim = int(rs.randint(1, 4))
        src_shape = tuple(int(rs.randint(1, 9)) for _ in range(ndim))
        sel = []
        src_region = _random_region(rs, src_shape, sel)
        dest_shape = tuple(s + int(rs.randint(0, 3)) for s in sel) or (1,)
        dest_region = tuple(slice(0, s) for s in sel) or (slice(0, 1),)
        if not sel:
            dest_shape, dest_region = (), ()
        h_src = rs.uniform(size=src_shape).astype(np.float32)
        h_dest = rs.uniform(size=dest_shape).astype(np.float32)
        expected = h_dest.copy()
        expected[dest_region] = h_src[src_region].reshape(expected[dest_region].shape)
        msg = f"trial {trial}: {src_region} -> {dest_region}"

        want = jregions.copy_region(jnp.asarray(h_src), jnp.asarray(h_dest), src_region,
                                    dest_region)
        got = regions.copy_region(torch.from_numpy(h_src), torch.from_numpy(h_dest.copy()),
                                  src_region, dest_region)
        _assert_bits_equal(expected, np.asarray(want))
        np.testing.assert_array_equal(_bits(expected), _bits(got.numpy()), err_msg=msg)
        got = regions.set_region(torch.from_numpy(h_dest.copy()), h_src, dest_region,
                                 src_region)
        np.testing.assert_array_equal(_bits(expected), _bits(got.numpy()), err_msg=msg)
        h_out = h_dest.copy()
        regions.get_region(torch.from_numpy(h_src), h_out, src_region, dest_region)
        np.testing.assert_array_equal(_bits(expected), _bits(h_out), err_msg=msg)


def test_copy_region_donated_matches_eager():
    rs = np.random.RandomState(seed=3)
    h_src = rs.uniform(size=(10, 12)).astype(np.float32)
    h_dest = rs.uniform(size=(12, 10)).astype(np.float32)
    sr, dr = np.s_[2:6, 3:9], np.s_[4:8, 1:7]
    want = jregions.copy_region_donated(jnp.asarray(h_src), jnp.asarray(h_dest), sr, dr)
    eager = regions.copy_region(torch.from_numpy(h_src), torch.from_numpy(h_dest.copy()), sr, dr)
    dest = torch.from_numpy(h_dest.copy())
    donated = regions.copy_region_donated(torch.from_numpy(h_src), dest, sr, dr)
    assert donated is dest
    _assert_bits_equal(want, donated.numpy())
    _assert_bits_equal(eager.numpy(), donated.numpy())


def test_copy_region_donated_loops():
    # The JAX test's steady-state loop: the destination is updated each
    # iteration and stays valid (nothing is donated, nothing is cached).
    dest = torch.zeros((16, 16))
    jdest = jnp.zeros((16, 16), jnp.float32)
    for i in range(4):
        src = torch.full((8, 8), float(i + 1))
        out = regions.copy_region_donated(src, dest, np.s_[0:8, 0:8], np.s_[4:12, 4:12])
        assert out is dest
        jdest = jregions.copy_region_donated(jnp.asarray(src.numpy()), jdest, np.s_[0:8, 0:8],
                                             np.s_[4:12, 4:12])
    _assert_bits_equal(np.asarray(jdest), dest.numpy())
    np.testing.assert_allclose(dest[4:12, 4:12].numpy(), 4.0)
    np.testing.assert_allclose(dest[:4].numpy(), 0.0)


def test_copy_region_donated_validates():
    with pytest.raises(ValueError):
        regions.copy_region_donated(torch.zeros((4, 4)), torch.zeros((4, 4)),
                                    np.s_[0:2, 0:2], np.s_[0:3, 0:3])


def test_copy_region_within_one_tensor_reads_before_it_writes():
    """Overlapping regions of one tensor: the result is JAX's, which reads the
    source region whole before the destination is written."""
    h = np.arange(20, dtype=np.float32)
    want = jregions.copy_region(jnp.asarray(h), jnp.asarray(h), np.s_[0:12], np.s_[4:16])
    t = torch.from_numpy(h.copy())
    regions.copy_region(t, t, np.s_[0:12], np.s_[4:16])
    _assert_bits_equal(want, t.numpy())
    view = t[2:18]
    regions.copy_region(t, view, np.s_[8:20], np.s_[0:12])
    h2 = np.asarray(want).copy()
    h2[2:14] = np.asarray(want)[8:20].copy()
    _assert_bits_equal(h2, t.numpy())


def test_get_region_reads_only_the_region():
    """The region is sliced before it reaches the host: a strided source
    region lands in a contiguous host region, the rest of the array kept."""
    src = torch.arange(60, dtype=torch.float32).reshape(6, 10)
    ary = np.full((4, 4), -1.0, np.float32)
    regions.get_region(src, ary, np.s_[0:6:2, 2:8:2], np.s_[1:4, 0:3])
    want = np.full((4, 4), -1.0, np.float32)
    want[1:4, 0:3] = src.numpy()[0:6:2, 2:8:2]
    _assert_bits_equal(want, ary)
