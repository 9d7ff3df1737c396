"""flax's layer numerics shared by the port's models: ``lecun_normal``
initialization, ``nn.Dense(dtype=...)``, ``nn.Dropout`` drawing its mask
from a passed ``torch.Generator``, input-width inference for lazy layers
(flax infers widths from the sample ``Module.init`` sees), and ``remat``,
the counterpart of ``nn.remat`` around a transformer block.

Under a precision policy (``parallel/precision.py``) the parameters are
stored in the compute dtype, so ``dense``'s casts are no-ops; the
normalisations widen their 16-bit scale and bias to f32, as flax promotes
them against its f32 statistics.

The tensor-parallel layers (``ColumnParallelLinear``,
``RowParallelLinear``, ``VocabParallelEmbedding``) are flax's Dense and
Embed with JAX's Megatron ``with_partitioning`` layouts made explicit:
unbound they are the plain layers; ``bind_model_mesh`` gives a model's
partitioned modules a (data, model) mesh, and each layer keeps this
rank's slice of its parameters (``tp_specs`` lists the layouts) and runs
the conjugate collectives of ``parallel/collectives.py``.
``sharded_dropout`` is the dropout of an activation sharded over 'model'.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.parameter import is_lazy
from torch.utils.checkpoint import checkpoint

from distributed_tensorflow_tpu_torch.parallel import collectives as coll
from distributed_tensorflow_tpu_torch.parallel.mesh import MODEL_AXIS


LN_EPS = 1e-6   # flax nn.LayerNorm default (torch's is 1e-5)


def layer_norm(ln: nn.LayerNorm, x, dtype):
    """flax ``nn.LayerNorm(dtype=...)``: statistics in f32, output in
    ``dtype``."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(),
                        ln.bias.float(), LN_EPS).to(dtype)


@torch.no_grad()
def flax_init_(model: nn.Module, generator: torch.Generator | None):
    """Flax's initializers for every Linear, Embedding and LayerNorm of
    ``model``, drawn from ``generator`` on the CPU and copied to the
    model's device: Dense kernels lecun-normal (truncated at ±2σ), biases
    zero, embeddings normal with std ``features ** -0.5``, LayerNorm scale
    1 and bias 0; a MoE layer's stacked kernels and the tensor-parallel
    layers by their own ``reset_parameters``.  Returns ``model``."""
    for mod in model.modules():
        if isinstance(mod, nn.Linear):
            lecun_normal_(mod.weight, mod.in_features, generator)
            mod.bias.zero_()
        elif isinstance(mod, nn.Embedding):
            host = torch.empty(mod.weight.shape, dtype=torch.float32)
            host.normal_(0.0, math.sqrt(1.0 / mod.embedding_dim),
                         generator=generator)
            mod.weight.copy_(host)
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif getattr(mod, "draws_own_params", False):
            # MoE's stacked kernels and the tensor-parallel layers: each
            # draws its parameters whole and keeps its slice
            mod.reset_parameters(generator)
    return model


def lecun_normal_(p: torch.Tensor, fan_in: int,
                  generator: torch.Generator | None) -> None:
    """flax's ``lecun_normal`` into ``p``: a normal truncated at ±2σ whose
    variance is ``1 / fan_in`` (std / .87962566 makes up for the cut),
    drawn from ``generator`` on the CPU and copied to ``p``'s device."""
    std = math.sqrt(1.0 / fan_in)
    host = torch.empty(p.shape, dtype=torch.float32)
    nn.init.trunc_normal_(host, 0.0, std / .87962566103423978,
                          -2 * std / .87962566103423978,
                          2 * std / .87962566103423978, generator=generator)
    p.copy_(host)


def infer_shape(layer: nn.Module, x: torch.Tensor) -> None:
    """Give a lazy layer its input width from its first input, as flax's
    ``Module.init`` infers it from the sample (a no-op once it has one)."""
    if getattr(layer, "has_uninitialized_params", lambda: False)():
        layer.initialize_parameters(x)


def dense(lin: nn.Linear, x: torch.Tensor, dtype) -> torch.Tensor:
    """flax ``nn.Dense(dtype=...)``: input, kernel and bias in ``dtype``."""
    infer_shape(lin, x)
    bias = None if lin.bias is None else lin.bias.to(dtype)
    return F.linear(x.to(dtype), lin.weight.to(dtype), bias)


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: torch.Generator | None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability ``1 - rate`` and scale by
    ``1 / (1 - rate)``; the keep mask is drawn from ``generator``."""
    if not train or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def remat(block: nn.Module, x: torch.Tensor, *args,
          generator: torch.Generator | None = None) -> torch.Tensor:
    """``block(x, *args, generator=generator)`` with activation
    checkpointing (flax ``nn.remat`` around a block): the forward keeps
    the block's inputs and none of its activations, and the backward runs
    the block again to rebuild them (``torch.utils.checkpoint``,
    non-reentrant).  The parameters are the block's own, so the
    ``state_dict`` is the same with and without remat.  Where no gradient
    is taken (evaluation) the block runs once, as it is.

    The recompute must draw the dropout masks the forward drew, or the
    gradients belong to masks that were never applied.
    ``preserve_rng_state`` stashes only the default generators, so the
    state of ``generator`` (the engine's per-rank stream) is saved here
    before the block, set again for the recompute, and then put back to
    where the stream had got to, so that later draws are those of a run
    without remat.  On the card ``get_state``/``set_state`` are legal
    inside a CUDA graph capture, and a captured restore rewinds the
    replayed draws (``SyncEngine`` captures its chunks; ``clone_state``,
    by contrast, raises there)."""
    if not torch.is_grad_enabled():
        return block(x, *args, generator=generator)
    if generator is None:
        # dropout draws from the default generators, which
        # preserve_rng_state (on by default) stashes
        return checkpoint(block, x, *args, use_reentrant=False)
    entry = generator.get_state()
    recompute = False

    def run(x, *args):
        nonlocal recompute
        if not recompute:
            recompute = True
            return block(x, *args, generator=generator)
        now = generator.get_state()
        generator.set_state(entry)
        try:
            return block(x, *args, generator=generator)
        finally:
            generator.set_state(now)

    return checkpoint(run, x, *args, use_reentrant=False,
                      preserve_rng_state=False)


def bind_seq_mesh(model: nn.Module, mesh) -> nn.Module:
    """Give every module of ``model`` that runs sequence-parallel
    attention (those with a ``seq_mesh`` attribute) the mesh whose ``seq``
    axis it shards over: ``SeqParallelEngine`` binds its mesh, as JAX's
    ``shard_map`` names the axis.  Returns ``model``."""
    for mod in model.modules():
        if hasattr(mod, "seq_mesh"):
            mod.seq_mesh = mesh
    return model


# --------------------------------------------------------------------------
# tensor parallelism: the Megatron layers over a mesh's 'model' axis
# --------------------------------------------------------------------------


def check_divisible(name: str, shape, dim: int, tp: int) -> None:
    """Raise as JAX does when a Megatron-annotated parameter's sharded
    dim does not split over the 'model' axis (its ``pjit`` refuses the
    layout)."""
    if shape[dim] % tp:
        spec = tuple(MODEL_AXIS if i == dim else None
                     for i in range(len(shape)))
        raise ValueError(
            f"parameter {name} was given the sharding of "
            f"PartitionSpec{spec} over a 'model' mesh axis of size {tp}, "
            f"which implies that the global size of its dimension {dim} "
            f"should be divisible by {tp}, but it is equal to "
            f"{shape[dim]} (full shape: {tuple(shape)})")


class _Partitioned(nn.Module):
    """A layer holding this rank's slice of its parameters along their
    'model' dims (``sharded``: parameter name → dim), once an engine has
    bound its mesh (``bind``); unbound it holds them whole and is the
    plain layer.  ``reset_parameters`` draws each parameter whole from
    the generator, as the plain layer draws it, and keeps its slice, so a
    partitioned model is the unpartitioned one cut up."""

    draws_own_params = True
    sharded: dict[str, int] = {}

    def __init__(self, whole: dict[str, tuple]):
        super().__init__()
        self.whole = whole           # parameter name -> its whole shape
        self.mesh, self.tp, self.tp_rank = None, 1, 0

    def bind(self, mesh, prefix: str = "") -> None:
        """Keep this rank's slice of every sharded parameter (once)."""
        if self.mesh is not None:
            return
        tp = mesh.axis_size(MODEL_AXIS)
        for pname, dim in self.sharded.items():
            if getattr(self, pname) is not None:
                check_divisible(f"{prefix}.{pname}".lstrip("."),
                                self.whole[pname], dim, tp)
        self.mesh, self.tp = mesh, tp
        self.tp_rank = mesh.axis_index(MODEL_AXIS)
        for pname in self.sharded:
            p = getattr(self, pname)
            if p is not None and not is_lazy(p):
                setattr(self, pname, nn.Parameter(self._cut(pname,
                                                            p.detach())))

    def _cut(self, pname: str, t: torch.Tensor) -> torch.Tensor:
        dim = self.sharded.get(pname)
        if self.mesh is None or dim is None:
            return t
        w = self.whole[pname][dim] // self.tp
        return t.narrow(dim, self.tp_rank * w, w).clone()

    def local_shape(self, pname: str) -> tuple:
        shape = list(self.whole[pname])
        if self.mesh is not None and pname in self.sharded:
            shape[self.sharded[pname]] //= self.tp
        return tuple(shape)

    def specs(self) -> dict[str, tuple]:
        """Each parameter's layout over the mesh: per dim, 'model' or
        None (``()`` when replicated)."""
        out = {}
        for pname, shape in self.whole.items():
            if getattr(self, pname) is None:
                continue
            dim = self.sharded.get(pname) if self.mesh is not None else None
            out[pname] = (() if dim is None else tuple(
                MODEL_AXIS if i == dim else None for i in range(len(shape))))
        return out


class _PartitionedLinear(_Partitioned):
    """A Dense layer: ``weight (out, in)``, ``bias (out,)``."""

    def __init__(self, in_features: int | None, out_features: int,
                 bias: bool = True, device=None):
        super().__init__({"weight": (out_features, in_features),
                          "bias": (out_features,)})
        self.in_features, self.out_features = in_features, out_features
        self.weight = (nn.UninitializedParameter(device=device)
                       if in_features is None else
                       nn.Parameter(torch.empty(out_features, in_features,
                                                device=device)))
        self.bias = (nn.Parameter(torch.empty(out_features, device=device))
                     if bias else None)

    def _infer(self, x: torch.Tensor) -> None:
        """A lazy input width from the first input (flax infers it)."""
        if is_lazy(self.weight):
            self.in_features = x.shape[-1]
            self.whole["weight"] = (self.out_features, self.in_features)
            self.weight.materialize(self.local_shape("weight"))

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """flax's ``lecun_normal`` kernel drawn whole (fan-in
        ``in_features``), this rank's slice kept; zero bias."""
        whole = torch.empty(self.whole["weight"])
        lecun_normal_(whole, self.in_features, generator)
        self.weight.copy_(self._cut("weight", whole))
        if self.bias is not None:
            self.bias.zero_()
        return self


class ColumnParallelLinear(_PartitionedLinear):
    """flax ``nn.Dense`` with its kernel's output columns sharded:
    ``weight (out/tp, in)`` and ``bias (out/tp,)`` (``shard_bias=False``:
    the bias stays whole, the untied LM head's).  The output is this
    rank's columns.  The input is replicated: the caller passes it
    through ``collectives.copy_to_model`` once (one all-reduce of its
    gradient serves the Q, K and V projections)."""

    def __init__(self, in_features, out_features, bias: bool = True,
                 shard_bias: bool = True, device=None):
        super().__init__(in_features, out_features, bias, device)
        self.sharded = ({"weight": 0, "bias": 0} if shard_bias
                        else {"weight": 0})

    def forward(self, x, dtype, bias: bool = True):
        self._infer(x)
        b = self.bias if bias else None
        return F.linear(x.to(dtype), self.weight.to(dtype),
                        None if b is None else b.to(dtype))


class RowParallelLinear(_PartitionedLinear):
    """flax ``nn.Dense`` with its kernel's input rows sharded: ``weight
    (out, in/tp)``, ``bias (out,)`` whole.  The input is this rank's
    columns (a column-parallel layer's output); the partial products are
    summed over 'model' (``reduce_from_model``).  The bias is added once:
    'model' rank 0 adds it in its GEMM, so at tp = 1 the layer is the
    plain one.  Every other rank adds ``bias - bias.detach()``, zeros
    whose gradient is the bias's, so each rank of a 'model' group takes
    the whole bias gradient, as a replicated parameter must."""

    sharded = {"weight": 1}

    def forward(self, x, dtype):
        b = self.bias
        if b is not None:
            b = (b if self.tp_rank == 0 else b - b.detach()).to(dtype)
        y = F.linear(x.to(dtype), self.weight.to(dtype), b)
        return y if self.mesh is None else coll.reduce_from_model(
            y, self.mesh)


class VocabParallelEmbedding(_Partitioned):
    """flax ``nn.Embed`` with its rows (the vocabulary) sharded: ``weight
    (vocab/tp, features)``.  A lookup finds each id on the rank that
    holds its row: ids outside this rank's rows read zeros, and the
    ranks' results are summed (``reduce_from_model``).  ``attend(x)`` is
    the tied head's product against this rank's rows: vocab-sharded
    logits."""

    sharded = {"weight": 0}

    def __init__(self, num_embeddings: int, embedding_dim: int, device=None):
        super().__init__({"weight": (num_embeddings, embedding_dim)})
        self.num_embeddings, self.embedding_dim = (num_embeddings,
                                                   embedding_dim)
        self.weight = nn.Parameter(torch.empty(num_embeddings,
                                               embedding_dim, device=device))

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """flax's embedding init (normal, std ``features ** -0.5``) drawn
        whole, this rank's rows kept."""
        whole = torch.empty(self.whole["weight"])
        whole.normal_(0.0, math.sqrt(1.0 / self.embedding_dim),
                      generator=generator)
        self.weight.copy_(self._cut("weight", whole))
        return self

    def forward(self, ids):
        if self.mesh is None:
            return F.embedding(ids, self.weight)
        rows = self.weight.shape[0]
        local = ids - self.tp_rank * rows
        inside = (local >= 0) & (local < rows)
        out = F.embedding(local.clamp(0, rows - 1), self.weight)
        out = torch.where(inside[..., None], out, torch.zeros_like(out))
        return coll.reduce_from_model(out, self.mesh)

    def attend(self, x, dtype):
        """``x @ weightᵀ`` in ``dtype`` over this rank's rows; a bound
        layer takes ``x`` through ``copy_to_model``."""
        if self.mesh is not None:
            x = coll.copy_to_model(x, self.mesh)
        return F.linear(x, self.weight.to(dtype))


def unbound_kw(kw: dict) -> dict:
    """A pipeline stage's constructor arguments for its whole, unbound
    twin (JAX ``PipelineEngine._oracle_stages``): no Megatron layout, no
    ``seq_axis``, and the whole-sequence attention of a
    sequence-parallel ``attention_impl`` (``ring_flash`` and
    ``ulysses_flash`` keep the flash kernels, the others are dense)."""
    out = dict(kw)
    for key, off in (("partition_model", False), ("seq_axis", None)):
        if key in out:
            out[key] = off
    impl = out.get("attention_impl")
    if impl in ("ring", "ulysses"):
        out["attention_impl"] = "dense"
    elif impl in ("ring_flash", "ulysses_flash"):
        out["attention_impl"] = "flash"
    return out


def bind_model_mesh(model: nn.Module, mesh) -> nn.Module:
    """Give every module of ``model`` with a ``bind_tp`` hook (the
    partitioned attention, FFN, embeddings, TPMLP) the mesh whose
    'model' axis it shards over; each keeps this rank's slice of its
    layers' parameters.  Returns ``model``."""
    for name, mod in model.named_modules():
        if hasattr(mod, "bind_tp"):
            mod.bind_tp(mesh, name)
    return model


def tp_specs(model: nn.Module) -> dict[str, tuple]:
    """Each parameter's layout over the 'model' axis, by name: a tuple
    with 'model' at its sharded dim, ``()`` when replicated (JAX's
    ``with_partitioning`` specs, in the port's (out, in) layout)."""
    out = {name: () for name, _ in model.named_parameters()}
    for mname, mod in model.named_modules():
        if isinstance(mod, _Partitioned):
            for pname, spec in mod.specs().items():
                out[f"{mname}.{pname}".lstrip(".")] = spec
    return out


def sharded_dropout(x, rate: float, train: bool, generator, mesh,
                    dim: int):
    """``dropout`` of an activation sharded over 'model' along ``dim``
    (this rank holds its slice): the mask is drawn whole from the stream
    every rank of the 'model' axis shares and this rank keeps its slice,
    so each rank's mask differs and the whole equals the unpartitioned
    model's.  Without a mesh it is ``dropout``."""
    if mesh is None or not train or rate == 0.0:
        return dropout(x, rate, train, generator)
    tp, r = mesh.axis_size(MODEL_AXIS), mesh.axis_index(MODEL_AXIS)
    shape = list(x.shape)
    width = shape[dim]
    shape[dim] *= tp
    keep = (torch.rand(shape, generator=generator, device=x.device)
            >= rate).narrow(dim, r * width, width)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))
