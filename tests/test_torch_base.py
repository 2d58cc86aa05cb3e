"""The port's operation framework (katsdpsigproc_tpu_torch.ops.base) and
shape helpers against the JAX package's, on the CPU.

The cases of ``tests/test_base.py`` and ``tests/test_sequence_extra.py``,
each run on the port and, where the JAX package computes something, on
the JAX package with the same inputs (made with numpy).  Tolerance: exact
everywhere.  ``required_bytes`` differs from the JAX value by the TPU
(8, 128) tile rule alone, which the port does not carry over.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from katsdpsigproc_tpu.ops import base as jbase
from katsdpsigproc_tpu.utils import shapes as jshapes
from katsdpsigproc_tpu_torch.ops import base
from katsdpsigproc_tpu_torch.utils import shapes


def _unary(lib, name, fn):
    """An operation class over `lib` (the port's base or the JAX one): dest = fn(src)."""
    dtype = torch.float32 if lib is base else jnp.float32

    class Op(lib.Operation):
        def __init__(self, shape, factor=None):
            super().__init__()
            self.factor = factor
            self.slots["src"] = lib.Slot(shape, dtype, lib.Direction.IN)
            self.slots["dest"] = lib.Slot(shape, dtype, lib.Direction.OUT)

        def _run(self, src):
            return {"dest": fn(src, self.factor)}

        def parameters(self):
            return {"factor": self.factor}

    Op.__name__ = name
    return Op


_Scale = _unary(base, "_Scale", lambda x, f: x * f)
_AddOne = _unary(base, "_AddOne", lambda x, f: x + 1.0)
_Add = _unary(base, "_Add", lambda x, f: x + f)
_JScale = _unary(jbase, "_Scale", lambda x, f: x * f)
_JAddOne = _unary(jbase, "_AddOne", lambda x, f: x + 1.0)
_JAdd = _unary(jbase, "_Add", lambda x, f: x + f)


def _join(lib):
    dtype = torch.float32 if lib is base else jnp.float32

    class _Join(lib.Operation):
        def __init__(self, shape):
            super().__init__()
            for name in ("a", "b"):
                self.slots[name] = lib.Slot(shape, dtype, lib.Direction.IN)
            self.slots["dest"] = lib.Slot(shape, dtype, lib.Direction.OUT)

        def _run(self, a, b):
            return {"dest": a * b}

    return _Join


def _x(shape, seed=0):
    return np.random.RandomState(seed).standard_normal(shape).astype(np.float32)


class TestOperation:
    def test_functional_call(self):
        x = _x((4, 8))
        out = _Scale((4, 8), 2.0)(src=torch.from_numpy(x))["dest"]
        want = _JScale((4, 8), 2.0)(src=jnp.asarray(x))["dest"]
        np.testing.assert_array_equal(out.numpy(), np.asarray(want))

    def test_bound_call(self):
        op = _Scale((4, 8), 3.0)
        op.bind(src=torch.ones((4, 8)))
        op()
        np.testing.assert_array_equal(op.buffer("dest").numpy(), 3.0)

    def test_ensure_all_bound_allocates_outputs(self):
        op = _Scale((4, 8), 3.0)
        op.ensure_all_bound()
        assert op.buffer("dest").shape == (4, 8) and not op.buffer("dest").any()
        op()
        assert not op.buffer("dest").any()
        op.bind(src=torch.ones((4, 8)))
        op()
        np.testing.assert_array_equal(op.buffer("dest").numpy(), 3.0)

    def test_validation(self):
        op = _Scale((4, 8), 2.0)
        with pytest.raises(ValueError):
            op.bind(src=torch.ones((4, 9)))
        with pytest.raises(TypeError):
            op.bind(src=torch.ones((4, 8), dtype=torch.int32))
        with pytest.raises(KeyError):
            op.bind(nosuch=torch.ones((4, 8)))
        with pytest.raises(KeyError, match="missing"):
            op(other=torch.ones((4, 8)))

    @pytest.mark.parametrize("shape", [(4, 8), (8, 128), (100, 100), (5,)])
    def test_required_bytes_net_of_the_tile_rule(self, shape):
        op, jop = _Scale(shape, 2.0), _JScale(shape, 2.0)
        assert op.required_bytes() == 2 * int(np.prod(shape)) * 4
        # The JAX value is the same count over the (8, 128)-padded shape.
        tile = int(np.prod(jshapes.padded_shape(shape, jnp.float32)))
        assert jop.required_bytes() == 2 * tile * 4
        assert op.slots["src"].padded_shape == shape

    def test_invalidate_counts(self):
        """``invalidate`` is a no-op (an eager operation reads its state on
        every call): a state change such as ``Fill.set_value`` takes effect
        on the next call."""
        from katsdpsigproc_tpu_torch.ops import fill

        op = _Scale((2, 2), 3.0)
        op.invalidate()
        np.testing.assert_array_equal(op(src=torch.ones((2, 2)))["dest"].numpy(), 3.0)
        f = fill.Fill(fill.FillTemplate(None, np.float32, tuning={}), (2, 3))
        f.ensure_all_bound()
        for value in (2.0, 7.0):
            f.set_value(value)
            f()
            np.testing.assert_array_equal(f.buffer("data").numpy(), value)


def _chain(lib, scale, add):
    return lib.OperationSequence(
        [("scale", scale((4, 8), 2.0)), ("add", add((4, 8)))],
        compounds={"src": ["scale:src"], "mid": ["scale:dest", "add:src"],
                   "dest": ["add:dest"]})


class TestOperationSequence:
    def test_chain(self):
        x = _x((4, 8))
        out = _chain(base, _Scale, _AddOne)(src=torch.from_numpy(x))["dest"]
        want = _chain(jbase, _JScale, _JAddOne)(src=jnp.asarray(x))["dest"]
        np.testing.assert_array_equal(out.numpy(), np.asarray(want))

    def test_slot_names(self):
        seq = _chain(base, _Scale, _AddOne)
        assert set(seq.slots) == set(_chain(jbase, _JScale, _JAddOne).slots) == {
            "src", "mid", "dest"}
        assert seq.slots["src"].direction == base.Direction.IN
        assert seq.slots["mid"].direction == base.Direction.OUT
        assert seq.slots["dest"].direction == base.Direction.OUT

    def test_unwired_slots_get_prefixed_names(self):
        seq = base.OperationSequence([("s", _Scale((4, 8), 2.0))])
        assert set(seq.slots) == {"s:src", "s:dest"}

    def test_child_state_change_is_seen(self):
        """Changing a child's state (Fill.set_value) changes the next call."""
        from katsdpsigproc_tpu_torch.ops import fill, reduce as hreduce

        f = fill.Fill(fill.FillTemplate(None, np.float32, tuning={}), (3, 4))
        r = hreduce.HReduceTemplate(None, np.float32, op="plus", tuning={}).instantiate(
            shape=(3, 4))
        seq = base.OperationSequence(
            [("fill", f), ("hreduce", r)],
            compounds={"src": ["fill:data", "hreduce:src"], "dest": ["hreduce:dest"]})
        f.set_value(2.0)
        seq()
        np.testing.assert_array_equal(seq.buffer("dest").numpy(), 8.0)
        f.set_value(5.0)
        seq()
        np.testing.assert_array_equal(seq.buffer("dest").numpy(), 20.0)

    def test_compound_shape_mismatch(self):
        for lib, scale, add in ((base, _Scale, _AddOne), (jbase, _JScale, _JAddOne)):
            with pytest.raises(ValueError):
                lib.OperationSequence(
                    [("scale", scale((4, 8), 2.0)), ("add", add((8, 4)))],
                    compounds={"mid": ["scale:dest", "add:src"], "src": ["scale:src"]})

    def test_parameters(self):
        assert _chain(base, _Scale, _AddOne).parameters()["scale"] == {"factor": 2.0}

    @pytest.mark.parametrize("shape", [(8, 128), (16, 256)])
    def test_visualize_matches_jax(self, shape):
        """The same graph gives the same DOT text (at tile-aligned shapes,
        where the JAX padded shapes carry no tile padding)."""
        def seq(lib, scale, add):
            return lib.OperationSequence(
                [("scale", scale(shape, 2.0)), ("add", add(shape))],
                compounds={"src": ["scale:src"], "mid": ["scale:dest", "add:src"]})

        dot = base.visualize_operation(seq(base, _Scale, _AddOne))
        assert dot == jbase.visualize_operation(seq(jbase, _JScale, _JAddOne))
        assert '"slot:mid"' in dot and '"slot:add:dest"' in dot
        single = base.visualize_operation(_Scale(shape, 2.0))
        assert single == jbase.visualize_operation(_JScale(shape, 2.0))


def test_diamond_dataflow():
    """One producer feeding two consumers feeding a join."""
    shape = (8, 16)

    def build(lib, add, join):
        return lib.OperationSequence(
            [("src_op", add(shape, 1.0)), ("left", add(shape, 10.0)),
             ("right", add(shape, 100.0)), ("join", join(shape))],
            compounds={"x": ["src_op:src"], "mid": ["src_op:dest", "left:src", "right:src"],
                       "l": ["left:dest", "join:a"], "r": ["right:dest", "join:b"],
                       "out": ["join:dest"]})

    x = _x(shape, 3)
    out = build(base, _Add, _join(base))(x=torch.from_numpy(x))["out"].numpy()
    mid = x + np.float32(1.0)
    np.testing.assert_array_equal(out, (mid + np.float32(10.0)) * (mid + np.float32(100.0)))
    # Under jit XLA folds (x + 1) + 10 into x + 11, which may round
    # differently in the last place.
    want = build(jbase, _JAdd, _join(jbase))(x=jnp.asarray(x))["out"]
    np.testing.assert_allclose(out, np.asarray(want), rtol=2e-7)


def test_bound_style_sequence():
    shape = (4, 4)
    seq = base.OperationSequence(
        [("a", _Add(shape, 2.0)), ("b", _Add(shape, 3.0))],
        compounds={"x": ["a:src"], "m": ["a:dest", "b:src"], "y": ["b:dest"]})
    seq.bind(x=torch.ones(shape))
    seq()
    np.testing.assert_array_equal(seq.buffer("y").numpy(), 6.0)
    np.testing.assert_array_equal(seq.buffer("m").numpy(), 3.0)  # intermediates too


def test_duplicate_child_names_rejected():
    with pytest.raises(ValueError):
        base.OperationSequence([("a", _Add((4, 4), 1.0)), ("a", _Add((4, 4), 2.0))])


def test_unknown_compound_members_rejected():
    with pytest.raises(KeyError):
        base.OperationSequence([("a", _Add((4, 4), 1.0))], compounds={"x": ["b:src"]})
    with pytest.raises(KeyError):
        base.OperationSequence([("a", _Add((4, 4), 1.0))], compounds={"x": ["a:nosuch"]})


def test_required_bytes_accounts_all_slots():
    def build(lib, add):
        return lib.OperationSequence(
            [("a", add((8, 128), 1.0)), ("b", add((8, 128), 2.0))],
            compounds={"x": ["a:src"], "m": ["a:dest", "b:src"], "y": ["b:dest"]})

    # (8, 128) float32 is tile-aligned, so the two frameworks agree.
    assert build(base, _Add).required_bytes() == build(jbase, _JAdd).required_bytes() == \
        3 * 8 * 128 * 4


def test_as_output():
    arr = torch.zeros(3)
    assert base.as_output("dest", arr) == {"dest": arr}


class TestDimension:
    """Requirement declaration, union-find linking, conflicts, freeze on bind."""

    def test_required_padded_size(self):
        for lib in (base, jbase):
            d = lib.Dimension(100, min_padded_round=32)
            assert d.required_padded_size() == 128
            d2 = lib.Dimension(100, min_padded_size=130, alignment=8)
            assert d2.required_padded_size() == 136
            assert d2.valid(136) and d2.valid(144) and not d2.valid(130)

    def test_exact(self):
        d = base.Dimension(96, exact=True)
        assert d.valid(96) and not d.valid(128)

    def test_validation(self):
        with pytest.raises(ValueError, match="power of 2"):
            base.Dimension(8, alignment=3)
        with pytest.raises(ValueError, match="less than size"):
            base.Dimension(8, min_padded_size=4)

    def test_link_merges_requirements(self):
        a = base.Dimension(100, min_padded_size=120)
        b = base.Dimension(100, alignment=16)
        a.link(b)
        assert a.required_padded_size() == b.required_padded_size() == 128
        c = base.Dimension(100, min_padded_size=200)
        b.link(c)
        assert a.required_padded_size() == 208

    def test_link_size_mismatch(self):
        with pytest.raises(ValueError, match="incompatible"):
            base.Dimension(100).link(base.Dimension(101))

    def test_link_exact_conflict(self):
        with pytest.raises(ValueError, match="unsatisfiable"):
            base.Dimension(96, exact=True).link(base.Dimension(96, min_padded_size=128))

    def test_freeze_blocks_linking(self):
        a = base.Dimension(64)
        a.freeze()
        with pytest.raises(ValueError, match="frozen"):
            a.link(base.Dimension(64))

    def test_slot_padded_shape_honours_dimensions(self):
        def slot(lib, dtype):
            dims = [lib.Dimension(4, min_padded_size=32), lib.Dimension(8, min_padded_size=500)]
            return lib.Slot((4, 8), dtype, lib.Direction.IN, dimensions=dims)

        # Where the dimensions ask for more than the TPU tile, the two agree.
        assert slot(base, torch.float32).padded_shape == (32, 500)
        assert slot(jbase, jnp.float32).padded_shape == (32, 500)
        assert base.Slot((4, 8), torch.float32, base.Direction.IN).padded_shape == (4, 8)

    def test_sequence_links_compound_dimensions(self):
        class _WithDims(base.Operation):
            def __init__(self, direction, **dim_kw):
                super().__init__()
                dims = [base.Dimension(4), base.Dimension(8, **dim_kw)]
                self.slots["x"] = base.Slot((4, 8), torch.float32, direction, dimensions=dims)

            def _run(self, **inputs):
                return {} if "x" in inputs else {"x": torch.zeros((4, 8))}

        seq = base.OperationSequence(
            [("p", _WithDims(base.Direction.OUT, min_padded_size=192)),
             ("c", _WithDims(base.Direction.IN, alignment=128))],
            compounds={"x": ["p:x", "c:x"]})
        assert seq.slots["x"].padded_shape[1] == 256  # 192 rounded up to 128
        with pytest.raises(ValueError, match="axis 1"):
            base.OperationSequence(
                [("p", _WithDims(base.Direction.OUT, min_padded_size=192)),
                 ("c", _WithDims(base.Direction.IN, exact=True))],
                compounds={"x": ["p:x", "c:x"]})

    def test_bind_freezes_dimensions(self):
        op = _Scale((4, 8), 2.0)
        op.bind(src=torch.ones((4, 8)))
        with pytest.raises(ValueError, match="frozen"):
            op.slots["src"].dimensions[0].link(base.Dimension(4))


class TestShapes:
    def test_divup_roundup(self):
        for a, b in ((7, 3), (6, 3), (1, 128), (129, 128)):
            assert shapes.divup(a, b) == jshapes.divup(a, b)
            assert shapes.roundup(a, b) == jshapes.roundup(a, b)

    def test_pad_to_and_crop_roundtrip(self):
        x = np.arange(12, dtype=np.float32).reshape(3, 4)
        padded = shapes.pad_to(torch.from_numpy(x), (5, 6), pad_value=float("nan"))
        want = jshapes.pad_to(jnp.asarray(x), (5, 6), pad_value=jnp.nan)
        np.testing.assert_array_equal(padded.numpy(), np.asarray(want))
        np.testing.assert_array_equal(shapes.crop_to(padded, (3, 4)).numpy(), x)
        t = torch.from_numpy(x)
        assert shapes.pad_to(t, (3, 4)) is t and shapes.crop_to(t, (3, 4)) is t

    @pytest.mark.parametrize("dtype", [np.uint8, np.complex64])
    def test_pad_to_other_dtypes(self, dtype):
        x = np.arange(6).reshape(2, 3).astype(dtype)
        padded = shapes.pad_to(torch.from_numpy(x), (4, 3), pad_value=7)
        np.testing.assert_array_equal(padded.numpy(),
                                      np.asarray(jshapes.pad_to(jnp.asarray(x), (4, 3), 7)))


def test_torch_dtype_names():
    for name, want in (("float32", torch.float32), (np.complex64, torch.complex64),
                       (np.dtype(np.uint8), torch.uint8), (torch.int32, torch.int32)):
        assert base.torch_dtype(name) == want
        assert base.dtype_name(want) == np.dtype(base.dtype_name(want)).name
