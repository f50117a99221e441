"""The weights bridge from the JAX package's parameter trees to the port.

``from_jax_params(trainable, frozen)`` takes the ``(trainable, frozen)``
trees of the JAX Show-Attend-Tell model as numpy arrays (any array that
``numpy.asarray`` accepts) and returns a state dict for
``ShowAttendTell.load_state_dict``. Layouts stay as they are, except:

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
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def from_jax_params(trainable: Params, frozen: Params) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    for k in ("w_img", "w_hh", "b_hh", "w_att"):
        sd[f"att.{k}"] = _t(trainable["att"][k])
    for name in _DENSE:
        sd[f"{name}.w"] = _t(trainable[name]["w"])
        sd[f"{name}.b"] = _t(trainable[name]["b"])
    sd["embed"] = _t(trainable["embed"])
    for i, conv in enumerate(frozen["convs"]):
        sd[f"encoder.convs.{i}.w"] = _t(np.asarray(conv["w"]).transpose(3, 2, 0, 1))
        sd[f"encoder.convs.{i}.b"] = _t(conv["b"])
    return sd
