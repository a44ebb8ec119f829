"""The active mesh of a training or decoding pass (the port's counterpart
of ``tpu_trainer/parallel/context.py``).

The JAX package publishes its mesh while it traces a step, so the model's
ops can ask what the ``tensor``, ``sequence``, ``expert`` and ``stage``
axes are.
Eager PyTorch traces nothing: ``use_mesh(ctx)`` is a plain module-level
scope around a forward (and the backward that runs inside it), and
``current_mesh()`` returns its ``MeshContext`` or None. The scope holds
the rank's coordinate and the intra-layer groups; the data-parallel
groups stay the trainer's (and the MoE routing group the model's
``moe_group``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

from tpu_trainer_torch.parallel.mesh import (
    EXPERT_AXIS,
    MESH_AXES,
    SEQUENCE_AXIS,
    STAGE_AXIS,
    TENSOR_AXIS,
)


@dataclasses.dataclass(frozen=True)
class MeshContext:
    """``sizes`` / ``coords``: the mesh and this rank's place on it (over
    ``MESH_AXES``). ``tensor``: the ``Collectives`` of the ranks that
    share every coordinate but the tensor one (Megatron's group), None at
    size 1. ``sequence``: likewise along ``sequence``, and ``permute`` the
    ring's permute over it (``collectives.SequencePermute``). ``expert``:
    likewise along ``expert``; ``expert_tensor`` the ranks that vary in
    their tensor and expert coordinates (a MoE layer's local experts sum
    their output over it), None when both sizes are 1. ``stage``: likewise
    along ``stage`` (the pipeline's ranks; their point-to-point sends and
    the 1F1B head's vocabulary slices run over it), ``schedule`` its
    ``parallel/pipeline.Schedule`` (None at stage size 1)."""

    sizes: tuple
    coords: tuple
    tensor: Optional[object] = None
    sequence: Optional[object] = None
    permute: Optional[object] = None
    expert: Optional[object] = None
    expert_tensor: Optional[object] = None
    stage: Optional[object] = None
    schedule: Optional[object] = None

    def _axis(self, name: str) -> int:
        return MESH_AXES.index(name)

    @property
    def tp(self) -> int:
        return self.sizes[self._axis(TENSOR_AXIS)]

    @property
    def tp_rank(self) -> int:
        return self.coords[self._axis(TENSOR_AXIS)]

    @property
    def sp(self) -> int:
        return self.sizes[self._axis(SEQUENCE_AXIS)]

    @property
    def sp_rank(self) -> int:
        return self.coords[self._axis(SEQUENCE_AXIS)]

    @property
    def ep(self) -> int:
        return self.sizes[self._axis(EXPERT_AXIS)]

    @property
    def ep_rank(self) -> int:
        return self.coords[self._axis(EXPERT_AXIS)]

    @property
    def pp(self) -> int:
        return self.sizes[self._axis(STAGE_AXIS)]

    @property
    def pp_rank(self) -> int:
        return self.coords[self._axis(STAGE_AXIS)]


_ACTIVE: Optional[MeshContext] = None


@contextlib.contextmanager
def use_mesh(ctx: Optional[MeshContext]):
    """Make ``ctx`` the active mesh for the duration (None: none)."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, ctx
    try:
        yield ctx
    finally:
        _ACTIVE = prev


def current_mesh() -> Optional[MeshContext]:
    """The active ``MeshContext``, else None (one process, no mesh)."""
    return _ACTIVE


def tensor_size() -> int:
    """The active mesh's tensor size (1 without one)."""
    return 1 if _ACTIVE is None else _ACTIVE.tp
