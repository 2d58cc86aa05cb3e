"""Operation framework: composable shape-specialized operations on tensors.

Port of ``katsdpsigproc_tpu/ops/base.py``.  The workflow is the JAX
package's (and the reference library's): build a template once,
instantiate it for a shape, then call the operation, either functionally
(``out = op(src=x)``) or bind-then-call (``op.bind(src=x); op();
op.buffer("dest")``).

* :class:`Dimension` is a per-axis padding requirement, merged between
  slots that share a buffer by union-find :meth:`Dimension.link` and
  frozen when a buffer is bound.
* :class:`Slot` is a named input or output: shape, ``torch.dtype``,
  direction, dimensions.  :attr:`Slot.padded_shape` honours the linked
  dimensions only; the JAX package's TPU (8, 128) tile rule has no
  counterpart, so :meth:`Slot.required_bytes` is the JAX value net of
  that rule.
* :class:`Operation` runs eagerly: PyTorch has no trace to compile, so
  ``_run`` is called on every call and :meth:`Operation.invalidate` is a
  no-op kept for API parity.
* :class:`OperationSequence` runs its children in order over named
  ``"child:slot"`` buffers.
* :func:`visualize_operation` renders the slot graph as Graphviz DOT,
  with the JAX package's text.
"""

import enum
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch


def torch_dtype(dtype) -> torch.dtype:
    """A ``torch.dtype`` from a torch dtype, numpy dtype or type, or its name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


def dtype_name(dtype: torch.dtype) -> str:
    """The numpy-style name of a torch dtype (``"float32"``, ``"complex64"``)."""
    return str(dtype).replace("torch.", "")


class Direction(enum.Enum):
    IN = "in"
    OUT = "out"


class Dimension:
    """Padding/alignment requirement for one axis of a :class:`Slot`.

    Port of ``katsdpsigproc_tpu/ops/base.py::Dimension``: operations
    declare requirements (``min_padded_round`` / ``min_padded_size``, a
    power-of-2 ``alignment``, ``exact``); composition links the
    dimensions of slots that share a buffer, merging requirements and
    failing fast on unsatisfiable combinations; binding a buffer freezes
    the requirement.
    """

    @staticmethod
    def _is_power2(value: int) -> bool:
        return value > 0 and (value & (value - 1)) == 0

    def __init__(self, size: int, min_padded_round: Optional[int] = None,
                 min_padded_size: Optional[int] = None, alignment: int = 1,
                 exact: bool = False) -> None:
        if min_padded_size is None:
            if min_padded_round is not None:
                min_padded_size = -(-size // min_padded_round) * min_padded_round
            else:
                min_padded_size = size
        if not self._is_power2(alignment):
            raise ValueError("alignment is not a power of 2")
        if min_padded_size < size:
            raise ValueError("padded size is less than size")
        self._parent: Optional["Dimension"] = None
        self._size = int(size)
        self._min_padded_size = int(min_padded_size)
        self._alignment = int(alignment)
        self._exact = bool(exact)
        self._frozen = False

    def _root(self) -> "Dimension":
        if self._parent is None:
            return self
        self._parent = self._parent._root()  # path compression
        return self._parent

    @property
    def size(self) -> int:
        return self._root()._size

    @property
    def exact(self) -> bool:
        return self._root()._exact

    @property
    def frozen(self) -> bool:
        return self._root()._frozen

    def required_padded_size(self) -> int:
        """Smallest padded size satisfying this requirement."""
        root = self._root()
        a = root._alignment
        return -(-root._min_padded_size // a) * a

    def valid(self, padded_size: int) -> bool:
        """Whether `padded_size` satisfies the requirement."""
        root = self._root()
        if root._exact:
            return padded_size == root.required_padded_size()
        return padded_size >= root._min_padded_size and padded_size % root._alignment == 0

    def link(self, other: "Dimension") -> None:
        """Share one requirement between `self` and `other` (union-find merge).

        Raises ``ValueError`` if either is frozen, the sizes differ, or an
        ``exact`` requirement cannot satisfy the other's constraints.
        """
        root1, root2 = self._root(), other._root()
        if root1 is root2:
            return
        if root1._frozen or root2._frozen:
            raise ValueError("cannot link frozen requirements")
        if root1._size != root2._size:
            raise ValueError("sizes are incompatible")
        for exact_root, other_root in ((root1, root2), (root2, root1)):
            if exact_root._exact and not other_root.valid(exact_root.required_padded_size()):
                raise ValueError("linked requirement is unsatisfiable")
        root1._min_padded_size = max(root1._min_padded_size, root2._min_padded_size)
        root1._alignment = max(root1._alignment, root2._alignment)
        root1._exact = root1._exact or root2._exact
        root2._parent = root1

    def freeze(self) -> None:
        """Prevent further modification (done when a buffer is bound)."""
        self._root()._frozen = True


class Slot:
    """A named buffer requirement on an operation.

    Port of ``katsdpsigproc_tpu/ops/base.py::Slot``.

    Parameters
    ----------
    shape
        Logical (unpadded) shape.
    dtype
        Element type (a ``torch.dtype``, or anything numpy names).
    direction
        Whether the operation consumes or produces this buffer.
    pad_value
        Value with which padding may be filled.
    dimensions
        One :class:`Dimension` per axis (default: no requirement).
    """

    def __init__(self, shape: Sequence[int], dtype, direction: Direction, pad_value=0,
                 dimensions: Optional[Sequence[Dimension]] = None):
        self.shape = tuple(int(s) for s in shape)
        self.dtype = torch_dtype(dtype)
        self.direction = direction
        self.pad_value = pad_value
        if dimensions is None:
            dimensions = [Dimension(s) for s in self.shape]
        else:
            dimensions = list(dimensions)
            if len(dimensions) != len(self.shape):
                raise ValueError("wrong number of dimensions")
            for s, d in zip(self.shape, dimensions):
                if d.size != s:
                    raise ValueError(f"dimension size {d.size} does not match shape entry {s}")
        self.dimensions: Tuple[Dimension, ...] = tuple(dimensions)

    @property
    def padded_shape(self) -> Tuple[int, ...]:
        """The smallest padded size of each axis that its :class:`Dimension` allows."""
        return tuple(d.required_padded_size() for d in self.dimensions)

    def required_bytes(self) -> int:
        n = 1
        for s in self.padded_shape:
            n *= s
        return n * self.dtype.itemsize

    def validate(self, array) -> None:
        if tuple(array.shape) != self.shape:
            raise ValueError(f"expected shape {self.shape}, got {tuple(array.shape)}")
        if array.dtype != self.dtype:
            raise TypeError(f"expected dtype {self.dtype}, got {array.dtype}")

    def __repr__(self) -> str:  # pragma: nocover
        return f"Slot({self.shape}, {dtype_name(self.dtype)}, {self.direction.value})"


class Operation:
    """A shape-specialized operation.

    Port of ``katsdpsigproc_tpu/ops/base.py::Operation``.  Subclasses fill
    ``self.slots`` and implement :meth:`_run`, mapping input tensors (by
    slot name) to a dict of output tensors (by slot name).  ``device`` is
    where :meth:`ensure_all_bound` allocates; templates set it from their
    context.

    Two calling conventions:

    * **functional**: ``outputs = op(vis=x)`` returns a dict of outputs;
    * **bound**: ``op.bind(vis=x); op(); out = op.buffer("deviations")``.
    """

    def __init__(self, device: Optional[torch.device] = None) -> None:
        self.slots: Dict[str, Slot] = {}
        self.device = torch.device("cpu") if device is None else torch.device(device)
        self._bound: Dict[str, Any] = {}

    def _run(self, **inputs):
        """Input tensors by slot name -> dict of output tensors by slot name."""
        raise NotImplementedError  # pragma: nocover

    def input_slots(self) -> Dict[str, Slot]:
        return {k: s for k, s in self.slots.items() if s.direction == Direction.IN}

    def output_slots(self) -> Dict[str, Slot]:
        return {k: s for k, s in self.slots.items() if s.direction == Direction.OUT}

    def required_bytes(self) -> int:
        """Total footprint of the slots' buffers."""
        return sum(s.required_bytes() for s in self.slots.values())

    def parameters(self) -> Mapping[str, Any]:
        """Configuration dump."""
        return {}

    def invalidate(self) -> None:
        """Note a change to state that :meth:`_run` reads (e.g. ``Fill.set_value``).

        A no-op kept for API parity: the JAX package drops its compiled
        trace here, and an eager operation reads its state on every call.
        """

    def bind(self, **tensors) -> None:
        """Attach tensors to slots, freezing each slot's dimensions."""
        for name, tensor in tensors.items():
            if name not in self.slots:
                raise KeyError(f"no slot named {name!r}")
            self.slots[name].validate(tensor)
            for d in self.slots[name].dimensions:
                d.freeze()
            self._bound[name] = tensor

    def ensure_all_bound(self) -> None:
        """Allocate zeroed tensors on ``device`` for every unbound slot, outputs included."""
        for name, slot in self.slots.items():
            if name not in self._bound:
                self._bound[name] = torch.zeros(slot.shape, dtype=slot.dtype, device=self.device)

    def buffer(self, name: str):
        """The tensor bound to (or produced for) `name`."""
        return self._bound[name]

    def __call__(self, **inputs):
        if inputs:
            in_slots = self.input_slots()
            for name in in_slots:
                if name not in inputs:
                    raise KeyError(f"missing input {name!r}")
            for name in inputs:
                if name not in in_slots:
                    raise KeyError(f"unknown input {name!r}")
            return self._run(**{k: inputs[k] for k in in_slots})
        # Bound style: consume bound inputs, store outputs for buffer().
        self.ensure_all_bound()
        outputs = self._run(**{k: self._bound[k] for k in self.input_slots()})
        self._bound.update(outputs)
        return outputs


class OperationSequence(Operation):
    """Compose child operations, run in order.

    Port of ``katsdpsigproc_tpu/ops/base.py::OperationSequence``.

    Parameters
    ----------
    operations
        Ordered ``(name, operation)`` pairs.
    compounds
        Mapping of sequence-level slot name -> list of ``"child:slot"``
        strings that all refer to the same buffer.  A compound written by
        an earlier child feeds the later children that read it.  Child
        slots named in no compound are exposed as ``"child:slot"``.
    """

    def __init__(self, operations: Sequence[Tuple[str, Operation]],
                 compounds: Optional[Mapping[str, Sequence[str]]] = None) -> None:
        operations = list(operations)
        super().__init__(operations[0][1].device if operations else None)
        self.operations = operations
        self.compounds = {k: list(v) for k, v in (compounds or {}).items()}
        self._child_by_name = dict(self.operations)
        if len(self._child_by_name) != len(self.operations):
            raise ValueError("duplicate child operation names")

        self._alias: Dict[Tuple[str, str], str] = {}
        for seq_name, members in self.compounds.items():
            for member in members:
                child, slot = member.split(":", 1)
                if child not in self._child_by_name:
                    raise KeyError(f"unknown child {child!r} in compound {seq_name!r}")
                if slot not in self._child_by_name[child].slots:
                    raise KeyError(f"child {child!r} has no slot {slot!r}")
                self._alias[(child, slot)] = seq_name

        # A compound is IN if some child reads it before any child writes
        # it; OUT if any child writes it.  Members must agree on shape and
        # dtype, and their dimensions are linked.
        produced: set = set()
        for child_name, child in self.operations:
            for slot_name, slot in child.slots.items():
                seq_name = self._seq_name(child_name, slot_name)
                if slot.direction == Direction.IN:
                    if seq_name in self.slots:
                        existing = self.slots[seq_name]
                        if existing.shape != slot.shape or existing.dtype != slot.dtype:
                            raise ValueError(
                                f"compound slot {seq_name!r} mismatch: "
                                f"{existing.shape}/{existing.dtype} vs {slot.shape}/{slot.dtype}")
                        self._link_dims(seq_name, existing, slot)
                    elif seq_name not in produced:
                        self.slots[seq_name] = Slot(slot.shape, slot.dtype, Direction.IN,
                                                    slot.pad_value, dimensions=slot.dimensions)
                else:
                    produced.add(seq_name)
                    if seq_name in self.slots:
                        self._link_dims(seq_name, self.slots[seq_name], slot)
                    self.slots[seq_name] = Slot(slot.shape, slot.dtype, Direction.OUT,
                                                slot.pad_value, dimensions=slot.dimensions)

    def _seq_name(self, child_name: str, slot_name: str) -> str:
        return self._alias.get((child_name, slot_name), f"{child_name}:{slot_name}")

    @staticmethod
    def _link_dims(seq_name: str, a: Slot, b: Slot) -> None:
        """Union-find merge of two compound members' axis requirements."""
        for axis, (da, db) in enumerate(zip(a.dimensions, b.dimensions)):
            try:
                da.link(db)
            except ValueError as exc:
                raise ValueError(f"compound slot {seq_name!r} axis {axis}: {exc}") from None

    def _run(self, **inputs):
        env: Dict[str, Any] = dict(inputs)
        for child_name, child in self.operations:
            child_inputs = {slot_name: env[self._seq_name(child_name, slot_name)]
                            for slot_name in child.input_slots()}
            for slot_name, value in child._run(**child_inputs).items():
                env[self._seq_name(child_name, slot_name)] = value
        return {name: env[name] for name in self.output_slots() if name in env}

    def parameters(self) -> Mapping[str, Any]:
        return {name: op.parameters() for name, op in self.operations}


def visualize_operation(op: Operation) -> str:
    """Render the operation/slot graph as Graphviz DOT text.

    Port of ``katsdpsigproc_tpu/ops/base.py::visualize_operation``; dtypes
    are written with their numpy names, so the text is the JAX package's
    wherever the padded shapes agree.
    """
    lines = ["digraph operation {", "  rankdir=LR;"]
    ops: List[Tuple[str, Operation]]
    if isinstance(op, OperationSequence):
        ops = op.operations
    else:
        ops = [("op", op)]
    for op_name, child in ops:
        lines.append(f'  "{op_name}" [shape=box,label="{op_name}\\n{type(child).__name__}"];')
    seen = set()
    for op_name, child in ops:
        for slot_name, slot in child.slots.items():
            seq_name = (op._seq_name(op_name, slot_name) if isinstance(op, OperationSequence)
                        else slot_name)
            if seq_name not in seen:
                seen.add(seq_name)
                label = (f"{seq_name}\\n{slot.shape} {dtype_name(slot.dtype)}"
                         f"\\npadded {slot.padded_shape}")
                lines.append(f'  "slot:{seq_name}" [shape=ellipse,label="{label}"];')
            if slot.direction == Direction.IN:
                lines.append(f'  "slot:{seq_name}" -> "{op_name}";')
            else:
                lines.append(f'  "{op_name}" -> "slot:{seq_name}";')
    lines.append("}")
    return "\n".join(lines)


def as_output(name: str, array) -> Dict[str, Any]:
    """Convenience for single-output ``_run`` implementations."""
    return {name: array}
