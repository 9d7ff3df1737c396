"""Elastic restore: a checkpoint onto this run's ranks (the part of the
JAX package's ``elastic/reshard.py`` that crash recovery needs).

The JAX module re-places every leaf of a restored state under the target
engine's partition specs, so a checkpoint of the GSPMD engine family
restores onto another device count or axis layout.  In the port the
engines whose ranks hold one state (sync/allreduce and sequence
parallel: every rank's full state is the same) restore onto any rank
count as they are, and the engines whose ranks hold slices (fsdp, tensor
parallel and fsdp × tp, expert parallel: ``Engine.param_specs``) write
whole leaves (gathered at save) and restore by cutting each rank's slice
onto any rank count whose axes divide the leaves, and under sync.  Local SGD and gossip save every rank's state and restore only
onto the rank count that wrote them; any other count raises
:class:`ElasticRestoreError`, as the per-device stacked state does in
JAX.
"""

from __future__ import annotations

import time
from typing import Any

from distributed_tensorflow_tpu_torch.parallel import precision as precisionlib


class ElasticRestoreError(RuntimeError):
    """A checkpoint could not be restored into the target engine's layout
    (shape/structure mismatch beyond what the restore can bridge)."""


class _StepPinned:
    """Adapter pinning ``restore`` to one step so the policy-aware restore
    helpers (which take only a manager) can restore a non-latest step."""

    def __init__(self, manager, step: int):
        self._manager, self._step = manager, step

    def restore(self, template: Any) -> Any:
        return self._manager.restore(template, self._step)


def elastic_restore(manager, engine, template: Any, *,
                    step: int | None = None) -> tuple[Any, dict | None]:
    """Restore a checkpoint onto ``engine``'s ranks, whatever rank count
    wrote it where the engine's state allows it.

    ``template`` is a fresh ``engine.init_state`` product — it fixes the
    target layout and dtypes (via the engine's precision policy) and is
    restored in place.  Returns ``(state, extra)``: the restored
    TrainState and the checkpoint's elastic sidecar (data state + save
    wall time; ``None`` for checkpoints without one —
    utils/checkpoint.py ``load_extra``).

    Precision crossings follow ``precision.restore_into_policy``: same
    policy restores directly, an f32-era checkpoint adopts into a master
    policy (restored f32 params become the master); other crossings raise.
    """
    policy = getattr(engine, "precision", None)
    if policy is None:
        policy = precisionlib.make_policy("f32")
    source = manager if step is None else _StepPinned(manager, step)
    try:
        state = precisionlib.restore_into_policy(source, template, policy)
    except Exception as e:
        mesh = engine.mesh
        mesh_shape = dict(mesh.shape) if mesh is not None else {"data": 1}
        raise ElasticRestoreError(
            f"elastic restore could not load the checkpoint under "
            f"{manager.directory} into this run's layout (target mesh "
            f"{mesh_shape}, precision '{policy.name}').  Cross-mesh "
            f"restore covers the GSPMD engine family (sync/allreduce, "
            f"fsdp, tensor-parallel and their composites), whose global "
            f"state shapes are mesh-independent; the per-device-stacked "
            f"engines (async/gossip) restore only onto the device count "
            f"they were saved from, and precision crossings other than "
            f"f32 → a master policy need the original --precision.  "
            f"Original error: {type(e).__name__}: {e}") from e
    extra = manager.load_extra(step)
    return state, extra


def preemption_lost_s(extra: dict | None,
                      now: float | None = None) -> float | None:
    """Seconds between the restored checkpoint's save and this resume —
    the MLPerf time-to-quality cost of the preemption (nothing trained in
    that window counts).  ``None`` when the checkpoint carries no save
    wall time — "not measured" stays distinguishable from a measured 0."""
    wall = (extra or {}).get("wall_time")
    if not isinstance(wall, (int, float)) or isinstance(wall, bool):
        return None
    return max((time.time() if now is None else now) - float(wall), 0.0)
