"""The weights bridge between the JAX package's parameter trees and the port.

``from_jax_params(trainable, frozen)`` takes the ``(trainable, frozen)``
trees of the JAX Show-Attend-Tell model as arrays (anything that
``numpy.asarray`` accepts, or torch tensors) and returns a state dict for
``ShowAttendTell.load_state_dict``; ``from_jax_trainable(trainable)`` gives
the trainable part alone, which is all that a JAX checkpoint holds, and
``to_jax_trainable`` is its inverse. Layouts stay as they are, except:

- the fused LSTM ``w [I+H, 4H]`` (gate order i, f, g, o, one bias) is kept
  whole, because the cell kernel consumes it;
- VGG conv weights move from HWIO ``[kh, kw, cin, cout]`` to PyTorch's
  ``[cout, cin, kh, kw]``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

Params = Dict

_DENSE = ("init_h", "init_c", "lstm", "c2o", "h2o", "classifier")


def _t(a) -> torch.Tensor:
    if torch.is_tensor(a):
        return a.detach().to(torch.float32).contiguous()
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def from_jax_trainable(trainable: Params) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    for k in ("w_img", "w_hh", "b_hh", "w_att"):
        sd[f"att.{k}"] = _t(trainable["att"][k])
    for name in _DENSE:
        sd[f"{name}.w"] = _t(trainable[name]["w"])
        sd[f"{name}.b"] = _t(trainable[name]["b"])
    sd["embed"] = _t(trainable["embed"])
    return sd


def to_jax_trainable(sd: Dict[str, torch.Tensor]) -> Params:
    """A state dict (or any dict keyed by the trainable parameters' names,
    such as the Adam moments) -> the JAX trainable tree, fp32 numpy."""
    a = {k: v.detach().cpu().float().numpy() for k, v in sd.items()}
    trainable: Params = {"att": {k: a[f"att.{k}"] for k in ("w_img", "w_hh", "b_hh", "w_att")}}
    for name in _DENSE:
        trainable[name] = {"w": a[f"{name}.w"], "b": a[f"{name}.b"]}
    trainable["embed"] = a["embed"]
    return trainable


def from_jax_params(trainable: Params, frozen: Params) -> Dict[str, torch.Tensor]:
    sd = from_jax_trainable(trainable)
    for i, conv in enumerate(frozen["convs"]):
        sd[f"encoder.convs.{i}.w"] = _t(np.asarray(conv["w"]).transpose(3, 2, 0, 1))
        sd[f"encoder.convs.{i}.b"] = _t(conv["b"])
    return sd
