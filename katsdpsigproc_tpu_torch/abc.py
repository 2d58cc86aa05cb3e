"""Typed protocols for the framework's conventions.

Port of ``katsdpsigproc_tpu/abc.py:16-49``: what a template, an operation
and an event look like.  They are ``typing.Protocol``\\ s (structural), so
user code satisfies them without inheriting.
"""

from typing import Any, Mapping, Protocol, runtime_checkable


@runtime_checkable
class AbstractTemplate(Protocol):
    """A configured operation factory: built once (tuning happens here),
    then ``instantiate``\\ d per shape."""

    def instantiate(self, command_queue, *args, **kwargs): ...  # pragma: nocover


@runtime_checkable
class AbstractOperation(Protocol):
    """A shape-specialized operation (:class:`.ops.base.Operation`)."""

    slots: Mapping[str, Any]

    def __call__(self, **inputs): ...  # pragma: nocover

    def parameters(self) -> Mapping[str, Any]: ...  # pragma: nocover

    def required_bytes(self) -> int: ...  # pragma: nocover


@runtime_checkable
class AbstractEventLike(Protocol):
    """Anything the resource layer can wait on.

    A ``torch.cuda.Event`` (which :func:`.utils.resource.wait_for_events`
    waits on with ``synchronize()``: its ``wait()`` makes a stream wait,
    not the host), or an object whose ``wait()`` blocks the host.  The
    resource layer also takes tensors (see
    :func:`.utils.resource.wait_for_events`).
    """

    def wait(self) -> None: ...  # pragma: nocover


__all__ = ["AbstractTemplate", "AbstractOperation", "AbstractEventLike"]
