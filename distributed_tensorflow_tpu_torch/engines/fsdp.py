"""FSDP engine: ZeRO-3 fully-sharded data parallelism (port of
``engines/fsdp.py``).

JAX places each state leaf with a ``NamedSharding`` that splits its
largest n-divisible dim over 'data' and lets GSPMD gather and scatter.
Here the collectives are explicit.  After ``init_state`` draws the
parameters whole, each rank keeps its slice of every leaf along the dim
``fsdp_spec`` picks (computed on the leaf's flax layout, so the same
logical dim as JAX's: a Linear weight is flax's kernel transposed), and
that slice becomes the module's parameter: the optimizer state and, under
a master policy, the f32 master (``MasterWeights``' flat buffers) are
built over the slices, so params, moments and master all sit at 1/n of
their bytes on each rank.  A leaf with no divisible dim stays whole.

A step gathers the sliced leaves for use (``collectives.gather_shards``:
one all-gather of every slice packed in a flat buffer, whose backward
packs the gradients alike and reduce-scatters them into the slices'
gradients: two collectives a step, as FSDP's flat parameters make them)
and runs the model through ``torch.func.functional_call`` on the
gathered tensors.  Each rank's loss
is the mean over its rows scaled by ``1/n``, so the reduce-scattered
gradient is the global-batch mean's (JAX ``:148-153``); the whole leaves'
gradients and the loss and accuracy go in one all-reduce over 'data'.
``grad_accum`` K gathers and scatters once a microbatch.  The step holds
no host sync, so on the card ``many_step`` replays each chunk of k > 1
steps as a CUDA graph, as ``SyncEngine``'s does (NCCL collectives inside
the capture; the launch counters move by what the capture recorded).

On a ('data', 'model') mesh (fsdp × tp) the engine first binds the mesh
to the model's partitioned layers (``models.layers.bind_model_mesh``),
whose Megatron slices take their dims first; ``fsdp_spec`` then cuts each
leaf's largest free dim over 'data' (``base``).

A gradient codec (JAX ``:155-171``): a ``roundtrip`` of the reduced
gradients over whole leaves with a rank-invariant stream
(``Engine._roundtrip_whole``); ``none`` keeps the plain step.  The
recipe's clip takes the global norm (``Engine._global_norm``).
``eval_params`` gathers a whole module (sampling and serving run on it),
and a checkpoint holds whole leaves (``Engine.checkpoint_state``), so it
restores onto any rank count and under ``SyncEngine``.
"""

from __future__ import annotations

import copy

import torch
from torch import nn
from torch.func import functional_call

from distributed_tensorflow_tpu_torch.engines.base import (
    TrainState, all_reduce_grads_, cross_entropy, spec_axes)
from distributed_tensorflow_tpu_torch.engines.sync import SyncEngine
from distributed_tensorflow_tpu_torch.models.layers import (
    _PartitionedLinear, bind_model_mesh, tp_specs)
from distributed_tensorflow_tpu_torch.parallel import collectives as coll
from distributed_tensorflow_tpu_torch.parallel import mesh as meshlib
from distributed_tensorflow_tpu_torch.parallel import precision as precisionlib


def fsdp_spec(shape: tuple[int, ...], n: int,
              axis: str = meshlib.DATA_AXIS,
              base: tuple | None = None) -> tuple:
    """The layout cutting the largest free ``n``-divisible dim over
    ``axis``, on top of ``base`` (the Megatron layout under fsdp × tp:
    dims already on 'model' are skipped), as a tuple of axis names and
    None (JAX ``fsdp_spec``'s ``PartitionSpec``).  A leaf with no such
    dim keeps ``base`` (``()`` when that cuts nothing)."""
    spec: list = list(base) if base else []
    spec += [None] * (len(shape) - len(spec))
    best = None
    for i, d in enumerate(shape):
        if spec[i] is None and d % n == 0 and d > 0 and (
                best is None or d > shape[best]):
            best = i
    if best is None:
        return tuple(spec) if any(s is not None for s in spec) else ()
    spec[best] = axis
    return tuple(spec)


def _flax_order(module: nn.Module, pname: str, ndim: int) -> tuple:
    """The port's dims in flax's order: a Dense kernel is (in, out) where
    the Linear weight is (out, in); a Conv kernel HWIO where the Conv2d
    weight is OIHW."""
    if pname == "weight" and isinstance(module, (nn.Linear,
                                                 _PartitionedLinear)):
        return (1, 0)
    if pname == "weight" and isinstance(module, nn.Conv2d):
        return (2, 3, 1, 0)
    return tuple(range(ndim))


def leaf_spec(module: nn.Module, pname: str, shape, n: int,
              base: tuple = ()) -> tuple:
    """``fsdp_spec`` of a parameter in the port's layout, chosen on its
    flax layout (so the cut dim is JAX's), with ``base`` its Megatron
    layout."""
    order = _flax_order(module, pname, len(shape))
    base = tuple(base) or (None,) * len(shape)
    spec = fsdp_spec(tuple(shape[i] for i in order), n,
                     base=tuple(base[i] for i in order))
    if not spec:
        return ()
    out = [None] * len(shape)
    for j, i in enumerate(order):
        out[i] = spec[j]
    return tuple(out)


class FSDPEngine(SyncEngine):
    """Fully-sharded sync data parallelism on a ('data',) mesh, or
    fsdp × tp on a ('data', 'model') mesh (module docstring): the
    training math of ``SyncEngine``, with each rank holding 1/n of the
    parameters, optimizer state and master."""

    supports_loss_scaling = True
    captures_chunks = True
    build_overlap_probe_fns = None

    def __init__(self, model, optimizer=None, mesh=None,
                 learning_rate: float = 1e-3, grad_accum: int = 1,
                 grad_compression: str = "none", grad_bucket_mb: float = 0.0,
                 precision: str = "f32", device=None):
        if mesh is not None:
            extra = set(mesh.axis_names) - {meshlib.DATA_AXIS,
                                            meshlib.MODEL_AXIS}
            if meshlib.DATA_AXIS not in mesh.axis_names or extra:
                raise ValueError(
                    f"FSDPEngine requires a ('data',) or ('data','model') "
                    f"mesh, got axes {mesh.axis_names}")
        super().__init__(model, optimizer, mesh, learning_rate,
                         grad_accum=grad_accum,
                         grad_compression=grad_compression,
                         grad_bucket_mb=grad_bucket_mb, precision=precision,
                         device=device)
        if mesh is not None and meshlib.MODEL_AXIS in mesh.axis_names:
            bind_model_mesh(self.model, mesh)
        # each sliced parameter's dim on 'data', and its shape before the
        # cut (filled by _own_params)
        self._data_dim: dict[str, int] = {}
        self._uncut: dict[str, torch.Size] = {}

    @property
    def codec_stream_words(self) -> tuple[int, ...]:
        """One codec stream for every rank: the roundtrip quantizes the
        reduced gradients' whole leaves."""
        return ()

    # ---------------------------------------------------------------- init
    def _param_slot(self, name: str):
        mname, _, pname = name.rpartition(".")
        return self.model.get_submodule(mname), pname

    def init_state(self, generator: torch.Generator,
                   sample_x=None) -> TrainState:
        """``Engine.init_state``: the parameters drawn whole (a module
        holding slices from an earlier init gets whole ones back first),
        then cut (``_own_params``) before the precision cast and the
        optimizer."""
        for name, shape in self._uncut.items():
            mod, pname = self._param_slot(name)
            old = getattr(mod, pname)
            setattr(mod, pname, nn.Parameter(torch.empty(
                shape, dtype=torch.float32 if old.is_floating_point()
                else old.dtype, device=old.device)))
        self._uncut.clear()
        return super().init_state(generator, sample_x)

    def _own_params(self, model: nn.Module) -> None:
        """Each parameter's layout (its Megatron slice's under fsdp × tp,
        then ``fsdp_spec`` over 'data'), and this rank's slice of each
        as the module's parameter."""
        if self.mesh is None:
            return
        n = self.n_devices
        base = (tp_specs(model) if meshlib.MODEL_AXIS in
                self.mesh.axis_names else {})
        specs = {}
        for mname, mod in model.named_modules():
            for pname, p in mod.named_parameters(recurse=False):
                name = f"{mname}.{pname}".lstrip(".")
                specs[name] = leaf_spec(mod, pname, p.shape, n,
                                        base.get(name, ()))
        self.param_specs = {k: v for k, v in specs.items() if v}
        self._data_dim = {k: v.index(meshlib.DATA_AXIS)
                          for k, v in self.param_specs.items()
                          if meshlib.DATA_AXIS in v}
        for name, dim in self._data_dim.items():
            mod, pname = self._param_slot(name)
            p = getattr(mod, pname).detach()
            self._uncut[name] = p.shape
            w = p.shape[dim] // n
            setattr(mod, pname, nn.Parameter(
                p.narrow(dim, self.rank * w, w).clone()))

    # ---------------------------------------------------------------- step
    def _gathered(self, model: nn.Module) -> dict:
        """Every sliced parameter gathered over 'data' for use: one
        all-gather for the slices of each dtype."""
        out: dict = {}
        by_dtype: dict = {}
        for name, p in model.named_parameters():
            if name in self._data_dim:
                by_dtype.setdefault(p.dtype, []).append((name, p))
        for leaves in by_dtype.values():
            whole = coll.gather_shards(
                [p for _, p in leaves],
                [self._data_dim[name] for name, _ in leaves], self.mesh,
                meshlib.DATA_AXIS)
            out.update(zip((name for name, _ in leaves), whole))
        return out

    def _step(self, state: TrainState, x, y):
        """One step on this rank's rows (module docstring); updates
        ``state`` in place and returns the global batch's mean ``loss``
        and ``accuracy`` as 0-dim device tensors."""
        k, n = self.grad_accum, self.n_devices
        if x.shape[0] % k:
            raise ValueError(f"per-device batch {x.shape[0]} not divisible "
                             f"by grad_accum {k}")
        model = state.model
        gen = self.step_generator(state)
        ls = (precisionlib.loss_scale_from(state.optimizer)
              if self.precision.loss_scaling else None)
        state.optimizer.zero_grad(set_to_none=True)
        loss = acc = 0.0
        for xc, yc in (zip(x.chunk(k), y.chunk(k)) if k > 1 else [(x, y)]):
            logits = functional_call(model, self._gathered(model), (xc,),
                                     {"train": True, "generator": gen})
            lc = cross_entropy(logits, yc).mean()
            ac = (logits.argmax(-1) == yc).float().mean()
            if ls is not None:
                (lc * ls / (n * k)).backward()
            else:
                (lc / (n * k) if n * k > 1 else lc).backward()
            loss, acc = loss + lc.detach(), acc + ac.detach()
        metrics = torch.stack([loss, acc])
        if k > 1:
            metrics = metrics / k
        if self.mesh is not None:
            # the whole leaves' gradients, the metrics with them
            whole = [p for name, p in model.named_parameters()
                     if name not in self._data_dim]
            metrics = all_reduce_grads_(whole, self.mesh, metrics,
                                        axis=meshlib.DATA_AXIS) / n
        if self.grad_codec.name != "none":
            self._roundtrip_whole(state)
        state.optimizer.step()
        state.step += 1
        return state, {"loss": metrics[0], "accuracy": metrics[1]}

    # ---------------------------------------------------------------- eval
    def eval_params(self, state: TrainState) -> nn.Module:
        """A module holding every parameter gathered over 'data' (a
        collective: every rank calls it); the state's own module when
        nothing is cut."""
        if not self._data_dim:
            return state.model
        whole = copy.deepcopy(state.model, memo={id(self.mesh): self.mesh})
        with torch.no_grad():
            for name, dim in self._data_dim.items():
                mname, _, pname = name.rpartition(".")
                p = state.model.get_parameter(name).detach()
                setattr(whole.get_submodule(mname), pname,
                        nn.Parameter(coll.all_gather(
                            p, self.mesh, tiled=True,
                            axis=meshlib.DATA_AXIS, dim=dim)))
        return whole

    def _reduce_totals(self, totals: torch.Tensor) -> None:
        # the ranks of a 'model' group scored the same rows
        coll.all_reduce_(totals, self.mesh, axis=meshlib.DATA_AXIS)

    # --------------------------------------------------------------- bytes
    def state_bytes_per_device(self, state: TrainState) -> tuple[int, int]:
        """(bytes on this rank, bytes if replicated) of the parameters and
        the optimizer state: the FSDP memory claim (JAX ``:205-218``)."""
        named = list(state.model.named_parameters())
        scale = {id(p): self._whole_numel(n, p) / max(p.numel(), 1)
                 for n, p in named}
        per = (self.param_bytes_per_device(state)
               + self.opt_state_bytes_per_device(state))
        whole = sum(p.numel() * p.element_size() * scale[id(p)]
                    for _, p in named)
        opt = state.optimizer
        if isinstance(opt, precisionlib.MasterWeights):
            local = sum(p.numel() for p in opt.params)
            ratio = sum(p.numel() * scale[id(p)] for p in opt.params) / local
            whole += sum(t.numel() * t.element_size()
                         * (ratio if t.numel() == local else 1)
                         for t in [opt.master, *opt._inner_state(),
                                   opt.loss_scale, opt.good_steps,
                                   opt.skipped, opt.last_skipped])
        else:
            for p, st in opt.state.items():
                for t in st.values():
                    if isinstance(t, torch.Tensor):
                        whole += t.numel() * t.element_size() * (
                            scale[id(p)] if t.numel() == p.numel()
                            and t.dim() else 1)
        return int(per), int(round(whole))

    def _whole_numel(self, name: str, p: torch.Tensor) -> int:
        n = p.numel()
        for dim, axis in spec_axes(self._spec(name)):
            n *= self.mesh.axis_size(axis)
        return n
