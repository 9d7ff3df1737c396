"""Carry a flax param tree across to the port's ``state_dict``.

The input is a JAX model's param tree as nested dicts of arrays (numpy, or
anything ``numpy.asarray`` reads); nothing here imports jax.  Rules:

* a Dense ``kernel (in, out)`` becomes a Linear ``weight (out, in)``;
* a Conv ``kernel (kh, kw, in, out)`` (flax HWIO) becomes a Conv2d
  ``weight (out, in, kh, kw)`` (OIHW);
* Embed tables are copied as they are (the tied head shares the single
  token embedding, so there is no separate head weight);
* a LayerNorm's or GroupNorm's ``scale``/``bias`` become its
  ``weight``/``bias``.

The CNN flattens its feature map in flax's NHWC order (``models/cnn.py``),
so its first Dense kernel needs no permutation of its rows.

A ``MoELayer``'s stacked kernels (``gate (d, E)``, ``w1 (E, d, hidden)``,
``w2 (E, hidden, d)``) keep their layout, with no transpose: the port's
layer holds them as plain parameters that feed einsums, not as
``nn.Linear`` weights (the gate too).  A GPT block or BERT layer with
experts holds ``MoELayer_0`` in place of ``Dense_0``/``Dense_1``.

JAX's ``PipelineEngine`` params ``{"embed", "blocks", "head"}`` hold
each block leaf stacked over the stages; ``pipeline_state_dicts`` turns
them into the stage modules' state_dicts (one per stage, the layers of a
GPT or BERT stage as ``layers.i``), and ``stacked_state_dict`` /
``unstacked_state_dicts`` move those to and from the stacked layout of a
pipeline checkpoint.

The output is f32.  An engine under a precision policy stores 16-bit
parameters (and a master policy an f32 master): such a state takes the
converted weights through ``parallel.precision.adopt_f32_state``, which
makes them the master and their downcast the parameters.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_BLOCK_CHILDREN = {
    "LayerNorm_0": "ln1",
    "LayerNorm_1": "ln2",
    "Dense_0": "fc1",
    "Dense_1": "fc2",
    "CausalSelfAttention_0": "attn",
    "MoELayer_0": "moe",
}
_MOE_PARAMS = ("gate", "w1", "w2")


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(np.asarray(a), dtype=np.float32))


def _module(tree: dict, prefix: str, out: dict) -> None:
    """One flax leaf module (Dense, Conv, LayerNorm or Embed) → state_dict
    keys."""
    if "kernel" in tree and np.ndim(tree["kernel"]) == 4:
        out[f"{prefix}.weight"] = _tensor(tree["kernel"]).permute(
            3, 2, 0, 1).contiguous()
        if "bias" in tree:
            out[f"{prefix}.bias"] = _tensor(tree["bias"])
    elif "kernel" in tree:
        out[f"{prefix}.weight"] = _tensor(tree["kernel"]).T.contiguous()
        if "bias" in tree:
            out[f"{prefix}.bias"] = _tensor(tree["bias"])
    elif "scale" in tree:
        out[f"{prefix}.weight"] = _tensor(tree["scale"])
        out[f"{prefix}.bias"] = _tensor(tree["bias"])
    elif "embedding" in tree:
        out[f"{prefix}.weight"] = _tensor(tree["embedding"])
    elif set(tree) == set(_MOE_PARAMS):
        for name in _MOE_PARAMS:
            out[f"{prefix}.{name}"] = _tensor(tree[name])
    else:
        raise KeyError(f"unrecognized flax module at {prefix}: "
                       f"{sorted(tree)}")


def _gpt_block(sub: dict, prefix: str, out: dict) -> None:
    """One flax ``GPTBlock`` → the port's ``GPTBlock`` keys."""
    for child, tree in sub.items():
        if child not in _BLOCK_CHILDREN:
            raise KeyError(f"unrecognized GPT block child {child}")
        target = _BLOCK_CHILDREN[child]
        if target == "attn":
            for proj in ("query", "key", "value", "out"):
                _module(tree[proj], f"{prefix}.attn.{proj}", out)
        else:
            _module(tree, f"{prefix}.{target}", out)


def gpt_state_dict(params: dict) -> dict[str, torch.Tensor]:
    """flax ``GPTLM`` params → ``GPTLM.state_dict()`` of the port (f32)."""
    out: dict[str, torch.Tensor] = {}
    for name, sub in params.items():
        m = re.fullmatch(r"GPTBlock_(\d+)", name)
        if m:
            _gpt_block(sub, f"blocks.{m.group(1)}", out)
        elif name == "LayerNorm_0":
            _module(sub, "ln_f", out)
        elif name in ("token_embed", "pos_embed", "lm_head"):
            _module(sub, name, out)
        else:
            raise KeyError(f"unrecognized GPT param {name}")
    return out


def mlp_state_dict(params: dict) -> dict[str, torch.Tensor]:
    """flax ``MLP`` params (``Dense_0``, ``Dense_1``) → ``MLP.state_dict()``."""
    out: dict[str, torch.Tensor] = {}
    for i in range(2):
        _module(params[f"Dense_{i}"], f"fc{i + 1}", out)
    return out


def moe_state_dict(params: dict) -> dict[str, torch.Tensor]:
    """flax ``MoEClassifier`` params (``Dense_0``, ``MoELayer_i``,
    ``Dense_1``) → ``MoEClassifier.state_dict()`` (f32)."""
    out: dict[str, torch.Tensor] = {}
    for name, sub in params.items():
        m = re.fullmatch(r"MoELayer_(\d+)", name)
        if m:
            _module(sub, f"moe.{m.group(1)}", out)
        elif name in ("Dense_0", "Dense_1"):
            _module(sub, {"Dense_0": "embed", "Dense_1": "head"}[name], out)
        else:
            raise KeyError(f"unrecognized MoE classifier param {name}")
    return out


def cnn_state_dict(params: dict) -> dict[str, torch.Tensor]:
    """flax ``CNN`` params (``Conv_i``, ``Dense_0``, ``Dense_1``) →
    ``CNN.state_dict()``."""
    out: dict[str, torch.Tensor] = {}
    convs = sorted((k for k in params if k.startswith("Conv_")),
                   key=lambda k: int(k.split("_")[1]))
    for i, name in enumerate(convs):
        _module(params[name], f"convs.{i}", out)
    for i in range(2):
        _module(params[f"Dense_{i}"], f"fc{i + 1}", out)
    return out


# flax BasicBlock children in creation order → the port's BasicBlock
_RESNET_BLOCK_CHILDREN = {
    "Conv_0": "conv1", "GroupNorm_0": "norm1",
    "Conv_1": "conv2", "GroupNorm_1": "norm2",
    "Conv_2": "proj", "GroupNorm_2": "proj_norm",
}


def resnet_state_dict(params: dict) -> dict[str, torch.Tensor]:
    """flax ``ResNet20`` params (``Conv_0``, ``GroupNorm_0``,
    ``BasicBlock_k``, ``Dense_0``) → ``ResNet20.state_dict()``."""
    out: dict[str, torch.Tensor] = {}
    for name, sub in params.items():
        m = re.fullmatch(r"BasicBlock_(\d+)", name)
        if m:
            for child, tree in sub.items():
                if child not in _RESNET_BLOCK_CHILDREN:
                    raise KeyError(f"unrecognized ResNet block child {child}")
                _module(tree, f"blocks.{m.group(1)}."
                        f"{_RESNET_BLOCK_CHILDREN[child]}", out)
        elif name in ("Conv_0", "GroupNorm_0", "Dense_0"):
            _module(sub, {"Conv_0": "stem", "GroupNorm_0": "stem_norm",
                          "Dense_0": "head"}[name], out)
        else:
            raise KeyError(f"unrecognized ResNet param {name}")
    return out


# flax TransformerLayer children → the port's TransformerLayer
_BERT_LAYER_CHILDREN = {
    "LayerNorm_0": "ln1", "Dense_0": "fc1", "Dense_1": "fc2",
    "LayerNorm_1": "ln2", "SelfAttention_0": "attn", "MoELayer_0": "moe",
}
_BERT_TOP = {
    "BertEmbeddings_0": ("embeddings", {"Embed_0": "token_embed",
                                        "Embed_1": "pos_embed",
                                        "LayerNorm_0": "ln"}),
    "BertPooler_0": ("pooler", {"Dense_0": "dense",
                                "Dense_1": "classifier"}),
}


def _bert_layer(sub: dict, prefix: str, out: dict) -> None:
    """One flax ``TransformerLayer`` → the port's keys."""
    for child, tree in sub.items():
        if child not in _BERT_LAYER_CHILDREN:
            raise KeyError(f"unrecognized BERT layer child {child}")
        target = f"{prefix}.{_BERT_LAYER_CHILDREN[child]}"
        if child == "SelfAttention_0":
            for proj in ("query", "key", "value", "out"):
                _module(tree[proj], f"{target}.{proj}", out)
        else:
            _module(tree, target, out)


def _bert_top(name: str, sub: dict, out: dict) -> None:
    """``BertEmbeddings_0`` or ``BertPooler_0`` → the port's keys."""
    top, children = _BERT_TOP[name]
    for child, tree in sub.items():
        if child not in children:
            raise KeyError(f"unrecognized BERT {name} child {child}")
        _module(tree, f"{top}.{children[child]}", out)


def bert_state_dict(params: dict) -> dict[str, torch.Tensor]:
    """flax ``BertTinyClassifier`` params (``BertEmbeddings_0``,
    ``TransformerLayer_i``, ``BertPooler_0``) →
    ``BertTinyClassifier.state_dict()`` (f32).  The tree is the same with
    and without ``remat`` (flax pins the layers' names)."""
    out: dict[str, torch.Tensor] = {}
    for name, sub in params.items():
        m = re.fullmatch(r"TransformerLayer_(\d+)", name)
        if m:
            _bert_layer(sub, f"blocks.{m.group(1)}", out)
        elif name in _BERT_TOP:
            _bert_top(name, sub, out)
        else:
            raise KeyError(f"unrecognized BERT param {name}")
    return out


def _cut_along(full: dict, specs: dict, axis: str, n: int,
               index: int) -> dict[str, torch.Tensor]:
    """``full`` with each entry whose layout (``specs``: name → tuple of
    axis names and None per dim) names ``axis`` cut to slice ``index`` of
    ``n`` along that dim; the others as they are."""
    out = {}
    for name, t in full.items():
        spec = specs.get(name, ())
        if axis in spec:
            dim = spec.index(axis)
            w = t.shape[dim] // n
            t = t.narrow(dim, index * w, w).contiguous()
        out[name] = t
    return out


def tp_shard_state_dict(full: dict, specs: dict, tp: int, rank: int,
                        ep: int = 1, expert_rank: int = 0
                        ) -> dict[str, torch.Tensor]:
    """A whole model's converted ``state_dict`` cut to tensor-parallel
    rank ``rank`` of ``tp`` (and expert rank ``expert_rank`` of ``ep``):
    each parameter the Megatron layout shards (``specs``, e.g.
    ``models.layers.tp_specs`` of a bound model, or an engine's
    ``param_specs``) keeps this rank's slice along its 'model' dim, and
    each MoE kernel its 'expert' slice, both under the 2-D expert layout
    (``w1`` as ('expert', None, 'model'), ``w2`` as ('expert', 'model',
    None)).  JAX's partitioned params arrive boxed (``nn.Partitioned``):
    unbox them (``flax.linen.unbox``) before converting;
    ``with_partitioning`` leaves their values as they are."""
    return _cut_along(_cut_along(full, specs, "model", tp, rank), specs,
                      "expert", ep, expert_rank)


def fsdp_shard_state_dict(full: dict, specs: dict, n: int,
                          rank: int) -> dict[str, torch.Tensor]:
    """A whole (or tensor-parallel rank's) ``state_dict`` cut to FSDP rank
    ``rank`` of ``n``: each parameter ``specs`` (``FSDPEngine.param_specs``)
    cuts over 'data' keeps this rank's slice along that dim."""
    return _cut_along(full, specs, "data", n, rank)


# --------------------------------------------------------------------------
# pipeline stages: JAX's {"embed", "blocks" (stacked), "head"} params
# --------------------------------------------------------------------------

# each stage family's flax leaf modules → the port's (the blocks' layers,
# GPTBlock_i and TransformerLayer_i, become layers.i)
_STAGE_MODULES = {
    "mlp": {"embed": {"Dense_0": "fc"},
            "block": {"LayerNorm_0": "ln", "Dense_0": "fc1",
                      "Dense_1": "fc2"},
            "head": {"LayerNorm_0": "ln", "Dense_0": "fc"}},
    "gpt": {"embed": {"Embed_0": "token_embed", "Embed_1": "pos_embed"},
            "block": {}, "head": {"LayerNorm_0": "ln_f",
                                  "Dense_0": "lm_head"}},
    "bert": {"embed": {}, "block": {}, "head": {}},
}


def _family(embed: dict) -> str:
    """The stage family of JAX pipeline params, from the embed's tree."""
    if "BertEmbeddings_0" in embed:
        return "bert"
    if "Embed_0" in embed:
        return "gpt"
    if set(embed) == {"Dense_0"}:
        return "mlp"
    raise KeyError(f"unrecognized pipeline embed params {sorted(embed)}")


def _stage(family: str, part: str, tree: dict) -> dict[str, torch.Tensor]:
    """One stage module's flax params → its ``state_dict``."""
    out: dict[str, torch.Tensor] = {}
    for name, sub in tree.items():
        m = re.fullmatch(r"(GPTBlock|TransformerLayer)_(\d+)", name)
        if part == "block" and m:
            (_gpt_block if m.group(1) == "GPTBlock" else _bert_layer)(
                sub, f"layers.{m.group(2)}", out)
        elif family == "bert" and name in _BERT_TOP:
            _bert_top(name, sub, out)
        elif name in _STAGE_MODULES[family][part]:
            _module(sub, _STAGE_MODULES[family][part][name], out)
        else:
            raise KeyError(f"unrecognized {family} {part} stage param "
                           f"{name}")
    return out


def pipeline_state_dicts(params: dict, specs: dict | None = None,
                         tp: int = 1, rank: int = 0, ep: int = 1,
                         expert_rank: int = 0
                         ) -> tuple[dict, list[dict], dict]:
    """JAX ``PipelineEngine`` params ``{"embed", "blocks", "head"}`` (the
    blocks' leaves stacked over a leading stage dim) → the port's stage
    modules' state_dicts: (embed, one per stage, head).  The family (the
    built-in MLP stages, the GPT or the BERT stages) is read from the
    embed's tree.  With ``specs`` (a ``PipelineEngine``'s
    ``param_specs``), each stage is cut to tensor-parallel rank ``rank``
    of ``tp`` and expert rank ``expert_rank`` of ``ep``
    (``tp_shard_state_dict``; a block leaf's layout after its 'pipe'
    entry, e.g. a MoE ``w1`` as ('expert', None, 'model'))."""
    family = _family(params["embed"])
    n = {np.shape(a)[0] for a in _flat(params["blocks"])}
    if len(n) != 1:
        raise ValueError(f"stacked block leaves disagree on the stage "
                         f"count: {sorted(n)}")
    stages = n.pop()
    blocks = [_stage(family, "block",
                     _map_tree(lambda a, s=s: np.asarray(a)[s],
                               params["blocks"]))
              for s in range(stages)]
    out = (_stage(family, "embed", params["embed"]), blocks,
           _stage(family, "head", params["head"]))
    if not specs:
        return out

    def cut(part: str, sd: dict) -> dict:
        own = {k[len(part) + 1:]: v[1:] if part == "block" else v
               for k, v in specs.items() if k.startswith(f"{part}.")}
        return tp_shard_state_dict(sd, own, tp, rank, ep, expert_rank)

    return (cut("embed", out[0]), [cut("block", b) for b in out[1]],
            cut("head", out[2]))


def stacked_state_dict(embed: dict, blocks: list[dict],
                       head: dict) -> dict[str, torch.Tensor]:
    """Stage state_dicts → the layout a pipeline checkpoint holds (the
    ``PipelineStages`` keys ``embed.*``, ``block.*``, ``head.*``), each
    block leaf stacked over the stages, ``(S, ...)``, as JAX's
    ``params["blocks"]``."""
    out = {f"embed.{k}": v for k, v in embed.items()}
    out.update({f"block.{k}": torch.stack([b[k] for b in blocks])
                for k in blocks[0]})
    out.update({f"head.{k}": v for k, v in head.items()})
    return out


def unstacked_state_dicts(stacked: dict) -> tuple[dict, list[dict], dict]:
    """``stacked_state_dict``'s inverse: (embed, one per stage, head)."""
    parts: dict = {"embed": {}, "block": {}, "head": {}}
    for key, v in stacked.items():
        part, _, name = key.partition(".")
        parts[part][name] = v
    n = {v.shape[0] for v in parts["block"].values()}
    blocks = [{k: v[s] for k, v in parts["block"].items()}
              for s in range(n.pop() if n else 0)]
    return parts["embed"], blocks, parts["head"]


def _flat(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _flat(v)]
    return [tree]


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)
