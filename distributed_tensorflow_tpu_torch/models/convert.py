"""Carry a flax GPT param tree across to the port's ``state_dict``.

The input is the JAX ``GPTLM`` param tree as nested dicts of arrays (numpy,
or anything ``numpy.asarray`` reads); nothing here imports jax.  Rules:

* a Dense ``kernel (in, out)`` becomes a Linear ``weight (out, in)``;
* Embed tables are copied as they are (the tied head shares the single
  token embedding, so there is no separate head weight);
* a LayerNorm's ``scale``/``bias`` become its ``weight``/``bias``.
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
}


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(np.asarray(a), dtype=np.float32))


def _module(tree: dict, prefix: str, out: dict) -> None:
    """One flax leaf module (Dense, LayerNorm or Embed) → state_dict keys."""
    if "kernel" in tree:
        out[f"{prefix}.weight"] = _tensor(tree["kernel"]).T.contiguous()
        if "bias" in tree:
            out[f"{prefix}.bias"] = _tensor(tree["bias"])
    elif "scale" in tree:
        out[f"{prefix}.weight"] = _tensor(tree["scale"])
        out[f"{prefix}.bias"] = _tensor(tree["bias"])
    elif "embedding" in tree:
        out[f"{prefix}.weight"] = _tensor(tree["embedding"])
    else:
        raise KeyError(f"unrecognized flax module at {prefix}: "
                       f"{sorted(tree)}")


def gpt_state_dict(params: dict) -> dict[str, torch.Tensor]:
    """flax ``GPTLM`` params → ``GPTLM.state_dict()`` of the port (f32)."""
    out: dict[str, torch.Tensor] = {}
    for name, sub in params.items():
        m = re.fullmatch(r"GPTBlock_(\d+)", name)
        if m:
            i = int(m.group(1))
            for child, tree in sub.items():
                if child not in _BLOCK_CHILDREN:
                    raise KeyError(f"unrecognized GPT block child {child}")
                target = _BLOCK_CHILDREN[child]
                if target == "attn":
                    for proj in ("query", "key", "value", "out"):
                        _module(tree[proj], f"blocks.{i}.attn.{proj}", out)
                else:
                    _module(tree, f"blocks.{i}.{target}", out)
        elif name == "LayerNorm_0":
            _module(sub, "ln_f", out)
        elif name in ("token_embed", "pos_embed", "lm_head"):
            _module(sub, name, out)
        else:
            raise KeyError(f"unrecognized GPT param {name}")
    return out
