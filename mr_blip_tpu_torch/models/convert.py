"""JAX package parameters -> the port's ``state_dict``.

Input: the nested parameter dict of ``mr_blip_tpu``'s ``BLIP2_MR`` (or
``BLIP2_MR_OPT``, a bare T5, or the zoo's ``BLIPv1``: ViT, MED, heads) as
numpy arrays, in the unscanned layout (``blocks_{i}``
/ ``block_{i}`` subtrees; convert a scanned tree with
``mr_blip_tpu.models.scan_utils.unstack_blip2_mr_params`` first). Output: a flat ``{name: tensor}`` dict
that ``Blip2MRModule.load_state_dict(..., strict=True)`` (or
``Blip2OPTModule``'s) takes.

Rules: flax ``Dense_0/kernel`` (in, out) becomes ``weight`` (out, in);
``LayerNorm_0/{scale,bias}`` and RMSNorm ``scale`` become
``weight``/``bias``; the patch conv goes HWIO -> OIHW; ``shared/embedding``
becomes ``shared.weight`` (OPT's ``embed_tokens`` / ``embed_positions`` and
MED's ``word_embeddings`` / ``position_embeddings`` likewise); numbered
children ``blocks_3`` become ``blocks.3``, and OPT's
``opt/layer_3`` becomes ``opt.layers.3``. Every other leaf keeps its name. A tree the JAX package has
already quantized converts too: ``kernel_q`` (int8, (in, out), stored here
with the input axis contiguous, as the W8A8 kernels read it),
``kernel_scale`` and the ``bias`` beside them keep their names under their
``qkv_packed`` / ``kv_packed`` / Dense parents. A leaf no rule knows raises,
so every leaf is consumed exactly once.

A QA model has a second tree, ``answerer_params``. The JAX package reads
only its ``t5`` subtree (vision, Q-Former and projection come from the main
tree), and so does this converter: that subtree becomes the ``answerer_t5.*``
entries, and the rest of the second tree is not looked at.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_NUMBERED = re.compile(r"^(blocks|block|layer)_(\d+)$")
_KEPT = {"lora_a", "lora_b", "q_bias", "v_bias", "cls_token", "pos_embed",
         "query_tokens", "rel_embedding"}


def _flatten(tree: Mapping, prefix=()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, value


def _convert_leaf(path, arr: np.ndarray, quantized_parents=frozenset()):
    *parents, leaf = path
    if tuple(parents) in quantized_parents and leaf in (
            "kernel_q", "kernel_scale", "bias"):
        return parents + [leaf], arr
    if parents and parents[-1] in ("Dense_0", "LayerNorm_0"):
        owner = parents.pop()
        if owner == "Dense_0" and leaf == "kernel":
            return parents + ["weight"], arr.T
        if leaf == "bias":
            return parents + ["bias"], arr
        if owner == "LayerNorm_0" and leaf == "scale":
            return parents + ["weight"], arr
    elif parents and parents[-1] == "patch_embed" and leaf in ("kernel", "bias"):
        return parents + ["weight" if leaf == "kernel" else "bias"], (
            arr.transpose(3, 2, 0, 1) if leaf == "kernel" else arr)
    elif parents and parents[-1] in ("shared", "embed_tokens", "embed_positions",
                                     "word_embeddings", "position_embeddings") \
            and leaf == "embedding":
        return parents + ["weight"], arr
    elif leaf == "scale":  # RMSNormFP32
        return parents + ["weight"], arr
    elif leaf in _KEPT:
        return parents + [leaf], arr
    raise ValueError(f"no conversion rule for JAX leaf {'/'.join(path)}")


def state_dict_from_jax(params: Mapping,
                        answerer_params: Mapping | None = None
                        ) -> Dict[str, torch.Tensor]:
    """Convert every leaf of the JAX parameter tree, and of the ``t5`` subtree
    of ``answerer_params`` when given; see the module doc."""
    out: Dict[str, torch.Tensor] = {}
    leaves = list(_flatten(params))
    if answerer_params is not None:
        leaves += list(_flatten({"answerer_t5": answerer_params["t5"]}))
    # Quantized layers: the parents of an int8 kernel_q (never a Dense_0).
    quantized = frozenset(path[:-1] for path, _ in leaves
                          if path[-1] == "kernel_q" and path[-2:-1] != ("Dense_0",))
    for path, arr in leaves:
        names, value = _convert_leaf(path, np.asarray(arr), quantized)
        parts = []
        for name in names:
            m = _NUMBERED.match(name)
            parts.extend(m.groups() if m else (name,))
        if parts[0] == "opt" and parts[1] == "layer":  # OPT's ModuleList
            parts[1] = "layers"
        key = ".".join(parts)
        if key in out:
            raise ValueError(f"two JAX leaves map to {key}")
        if value.dtype.name == "bfloat16":
            value = value.astype(np.float32)
        if names[-1] == "kernel_q":
            out[key] = torch.from_numpy(np.ascontiguousarray(value.T)).t()
        else:
            out[key] = torch.from_numpy(np.array(value))  # a writable copy
    return out
