"""Reference checkpoint I/O and the JAX variable bridge (counterpart of
vpt_tpu/checkpoint/torch_import.py).

  * ``.model``: a plain pickle with the architecture kwargs at
    ``["model"]["args"]["net"]["args"]`` and head options at
    ``["model"]["args"]["pi_head_opts"]``;
  * ``.weights``: a ``torch.save``'d state_dict, loaded ``strict=False``;
    ``save_weights`` writes one from a model, ``save_model_parameters`` a
    ``.model`` from kwargs.

The port's modules carry the reference's torch names, so a ``.weights``
state_dict loads as it is.  ``from_jax_variables`` carries a ``vpt_tpu``
flax variable tree (nested dicts of numpy arrays) into the same names,
with the layout transposes of the JAX converter: Linear (I,O)→(O,I),
Conv2d (kh,kw,I,O)→(O,I,kh,kw), Conv3d (kt,kh,kw,I,O)→(O,I,kt,kh,kw),
norm ``scale``→``weight``, ``blocks_0``→``blocks.0``, and the EWMA stats
under ``normalizer``.  A quantized tree (``vpt_tpu.ops.int8``) crosses too:
``kernel_q8`` (in, out) int8 → ``weight_q8`` (out, in) int8 and
``kernel_scale`` → ``weight_scale``.  So do the model variants: a flax
``OptimizedLSTMCell``'s per-gate kernels ``ii, if, ig, io`` (no bias) and
``hi, hf, hg, ho`` (with biases) become ``torch.nn.LSTM``'s ``weight_ih_l0``
(their (in, out) kernels concatenated in gate order i, f, g, o, then
transposed), ``weight_hh_l0``, ``bias_hh_l0`` and a zero ``bias_ih_l0``;
batch norm's ``batch_stats`` ``mean``/``var`` become ``running_mean``/
``running_var``; the gaussian head's ``linear_layer`` and ``log_std`` keep
their names.
"""

from __future__ import annotations

import pickle
import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

_LIST_SEG = re.compile(r"^(.*)_(\d+)$")
_EWMA_LEAVES = ("running_mean", "running_mean_sq", "debiasing_term")


class _TolerantUnpickler(pickle.Unpickler):
    """Stubs unknown globals: ``.model`` files may reference classes that are
    not needed to read the kwargs."""

    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except (ImportError, AttributeError):
            return type(name, (), {"__module__": module})


def load_model_parameters(path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Read a ``.model`` pickle → (policy_kwargs, pi_head_kwargs), with the
    reference's float() coercion of temperature (behavioural_cloning.py:41-47)."""
    with open(path, "rb") as f:
        agent_parameters = _TolerantUnpickler(f).load()
    policy_kwargs = agent_parameters["model"]["args"]["net"]["args"]
    pi_head_kwargs = agent_parameters["model"]["args"]["pi_head_opts"]
    if "temperature" in pi_head_kwargs:
        pi_head_kwargs["temperature"] = float(pi_head_kwargs["temperature"])
    return policy_kwargs, pi_head_kwargs


def save_model_parameters(path: str, policy_kwargs: Dict[str, Any], pi_head_kwargs: Dict[str, Any]) -> None:
    """Write a reference-layout ``.model`` pickle (the inverse of
    ``load_model_parameters``)."""
    blob = {"model": {"args": {"net": {"args": dict(policy_kwargs)}, "pi_head_opts": dict(pi_head_kwargs)}}}
    with open(path, "wb") as f:
        pickle.dump(blob, f)


def load_weights(path: str) -> Dict[str, torch.Tensor]:
    """Read a ``.weights`` file (a torch.save'd state_dict) onto the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def save_weights(path: str, model: torch.nn.Module) -> None:
    """Write ``model``'s state_dict (reference names, CPU tensors) as a
    ``.weights`` file."""
    torch.save({k: v.detach().cpu().clone() for k, v in model.state_dict().items()}, path)


def cast_params(module: torch.nn.Module, params_dtype: str) -> torch.nn.Module:
    """Cast ``module``'s float32 parameters of two or more dims (matrices,
    convolution kernels, the band tables) to bfloat16 in place, for serving:
    half the weight bytes a step reads.  Vectors (norm scales, biases) and
    buffers stay float32; the layers cast weights to their compute dtype, so
    the arithmetic is unchanged but for the rounded weights.  A no-op unless
    ``params_dtype`` is "bfloat16" (counterpart of the JAX ``cast_params``)."""
    if params_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"params_dtype must be float32 or bfloat16, got {params_dtype!r}")
    if params_dtype == "bfloat16":
        for p in module.parameters():
            if p.dtype == torch.float32 and p.dim() >= 2:
                p.data = p.data.to(torch.bfloat16)
    return module


_LEAF_NAMES = {"kernel": "weight", "kernel_q8": "weight_q8", "scale": "weight", "kernel_scale": "weight_scale"}


def _torch_leaf(name: str, value: np.ndarray) -> Tuple[str, np.ndarray]:
    if name in ("kernel", "kernel_q8"):
        if value.ndim == 2:
            value = value.transpose(1, 0)
        elif value.ndim == 4:
            value = value.transpose(3, 2, 0, 1)
        elif value.ndim == 5:
            value = value.transpose(4, 3, 0, 1, 2)
        else:
            raise ValueError(f"unsupported kernel ndim {value.ndim}")
    return _LEAF_NAMES.get(name, name), value


def _leaves(tree: Mapping, path=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, path + (str(key),))
        else:
            yield path + (str(key),), value


def torch_key(segs: Tuple[str, ...], collection: str = "params") -> str:
    """The state_dict name of the ``vpt_tpu`` variable at path ``segs`` of
    ``collection`` (e.g. ``("net", "recurrent_layer", "blocks_0", ..., "kernel")``)."""
    leaf = segs[-1]
    body = []
    for s in segs[:-1]:
        m = _LIST_SEG.match(s)
        if m and m.group(1) in ("blocks", "stacks"):
            body.extend([m.group(1), m.group(2)])
        else:
            body.append(s)
    if collection == "stats" and leaf in _EWMA_LEAVES:
        body.append("normalizer")
    return ".".join(body + [_LEAF_NAMES.get(leaf, leaf)])


_LSTM_GATES = ("i", "f", "g", "o")  # flax's and torch's gate order
_BATCH_STATS = {"mean": "running_mean", "var": "running_var"}


def _lstm_state_dict(prefix: str, gates: Dict[str, Dict[str, np.ndarray]]) -> Dict[str, torch.Tensor]:
    """One flax LSTM cell's gate Dense layers → ``torch.nn.LSTM`` names."""
    def cat(kind, leaf):
        return np.concatenate([np.asarray(gates[kind + g][leaf], np.float32) for g in _LSTM_GATES], axis=-1)

    w_hh = cat("h", "kernel").T
    tensors = {"weight_ih_l0": cat("i", "kernel").T, "weight_hh_l0": w_hh,
               "bias_ih_l0": np.zeros(w_hh.shape[0], np.float32), "bias_hh_l0": cat("h", "bias")}
    return {f"{prefix}.{k}": torch.from_numpy(np.ascontiguousarray(v)) for k, v in tensors.items()}


def from_jax_variables(variables: Mapping) -> Dict[str, torch.Tensor]:
    """A ``vpt_tpu`` variable tree ``{"params": ..., "stats": ...,
    "batch_stats": ...}`` of numpy arrays → a torch-layout state_dict of CPU
    tensors (float32, int8 codes kept int8)."""
    out: Dict[str, torch.Tensor] = {}
    lstm_cells: Dict[Tuple[str, ...], Dict[str, Dict[str, np.ndarray]]] = {}
    for collection in ("params", "stats", "batch_stats"):
        if collection not in variables:
            continue
        for segs, value in _leaves(variables[collection]):
            gate = segs[-2] if len(segs) >= 2 else ""
            if collection == "params" and len(gate) == 2 and gate[0] in "ih" and gate[1] in _LSTM_GATES:
                lstm_cells.setdefault(segs[:-2], {}).setdefault(gate, {})[segs[-1]] = value
                continue
            if collection == "batch_stats":
                segs = segs[:-1] + (_BATCH_STATS[segs[-1]],)
            _, arr = _torch_leaf(segs[-1], np.asarray(value))
            dtype = np.int8 if segs[-1] == "kernel_q8" else np.float32
            out[torch_key(segs, collection)] = torch.from_numpy(np.array(arr, dtype=dtype))
    for cell, gates in lstm_cells.items():
        out.update(_lstm_state_dict(torch_key(cell + ("weight",)).rsplit(".", 1)[0], gates))
    return out


def load_state_dict_report(model: torch.nn.Module, state_dict: Mapping[str, torch.Tensor]) -> Dict[str, list]:
    """``load_state_dict(strict=False)`` that also skips shape mismatches.

    :returns: {"unexpected": [...], "missing": [...], "shape_mismatch": [...]}
    """
    own = model.state_dict()
    usable, mismatch = {}, []
    for key, value in state_dict.items():
        if key in own and tuple(own[key].shape) != tuple(value.shape):
            if own[key].numel() == value.numel() == 1:
                value = value.reshape(own[key].shape)  # 0-d scalars saved as (1,)
            else:
                mismatch.append((key, tuple(own[key].shape), tuple(value.shape)))
                continue
        usable[key] = value
    result = model.load_state_dict(usable, strict=False)
    return {
        "unexpected": list(result.unexpected_keys),
        "missing": list(result.missing_keys),
        "shape_mismatch": mismatch,
    }
