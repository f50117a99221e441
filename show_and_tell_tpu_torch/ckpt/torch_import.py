"""Import reference-trained PyTorch checkpoints into the port.

A user of the reference code holds ``model-best.pth``, a state dict of its
``model2.ShowAttendTellModel``. This renames and reshapes it onto the port's
state dict, as the JAX package's ``ckpt/torch_import.py`` builds its trees:

- ``nn.Linear`` stores ``weight [out, in]``; the port's dense ``w`` is
  ``[in, out]``: transposed;
- ``nn.LSTMCell`` stores ``weight_ih [4H, in]`` and ``weight_hh [4H, H]``,
  gate order (i, f, g, o), and two biases; the port's cell is one
  ``w [in+H, 4H]`` (x rows first, then h rows) and ``b = b_ih + b_hh``;
- ``image_att_w`` and ``embedding.weight`` keep their layout, ``weight_att``
  is flattened;
- the reference's ``encoder.<i>.*`` keys are torchvision's VGG16
  ``features.<i>.*`` for the 12 kept convs, already in the port's
  ``[out, in, kh, kw]`` layout.

Only Show-Attend-Tell is ported; ``show_tell`` raises (ROADMAP.md A7).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from show_and_tell_tpu_torch.models.encoders import from_torch_vgg16

Tensors = Dict[str, torch.Tensor]

_SHOW_TELL = "model 'show_tell' is not ported to PyTorch yet; see ROADMAP.md A7"


def _arr(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32)


def _tt(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(_arr(a)))


def _linear(sd: Dict, prefix: str, name: str, out: Tensors) -> None:
    out[f"{name}.w"] = _tt(_arr(sd[f"{prefix}.weight"]).T)
    out[f"{name}.b"] = _tt(sd[f"{prefix}.bias"])


def _strip_prefix(sd: Dict, prefix: str) -> Dict:
    n = len(prefix)
    return {k[n:]: v for k, v in sd.items() if k.startswith(prefix)}


def trunk_state_dict(convs) -> Tensors:
    """The VGG16 trunk's ``[{"w", "b"}, ...]`` -> its state-dict entries."""
    sd: Tensors = {}
    for i, conv in enumerate(convs):
        sd[f"encoder.convs.{i}.w"] = torch.as_tensor(conv["w"], dtype=torch.float32)
        sd[f"encoder.convs.{i}.b"] = torch.as_tensor(conv["b"], dtype=torch.float32)
    return sd


def import_show_attend_tell(sd: Dict) -> Tuple[Tensors, Optional[Tensors]]:
    """A ``model2.ShowAttendTellModel`` state dict -> ``(trainable, trunk)``:
    the port's trainable state dict, and its trunk entries when the file
    holds ``encoder.*`` keys (a full save), else None."""
    out: Tensors = {
        "att.w_img": _tt(sd["image_att_w"]),
        "att.w_hh": _tt(_arr(sd["weight_hh.weight"]).T),
        "att.b_hh": _tt(sd["weight_hh.bias"]),
        "att.w_att": _tt(_arr(sd["weight_att"]).reshape(-1)),
        "embed": _tt(sd["embedding.weight"]),
    }
    _linear(sd, "init_hidden", "init_h", out)
    _linear(sd, "init_memory", "init_c", out)
    w_ih, w_hh = _arr(sd["lstmcell.weight_ih"]), _arr(sd["lstmcell.weight_hh"])
    out["lstm.w"] = _tt(np.concatenate([w_ih.T, w_hh.T], axis=0))
    out["lstm.b"] = _tt(_arr(sd["lstmcell.bias_ih"]) + _arr(sd["lstmcell.bias_hh"]))
    _linear(sd, "context2out", "c2o", out)
    _linear(sd, "hidden2tout", "h2o", out)
    _linear(sd, "classifier", "classifier", out)
    enc = _strip_prefix(sd, "encoder.")
    trunk = None
    if enc:
        trunk = trunk_state_dict(from_torch_vgg16({f"features.{k}": v for k, v in enc.items()})["convs"])
    return out, trunk


def load_reference_checkpoint(path: str, model: str = "show_attend_tell"):
    """``model-best.pth`` of the reference trainer -> ``(trainable,
    trunk_or_None)``, loaded on the CPU with ``weights_only=True``;
    DataParallel's ``module.`` prefix is stripped."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = {k: v.numpy() for k, v in sd.items()}
    if any(k.startswith("module.") for k in sd):
        sd = _strip_prefix(sd, "module.")
    if model == "show_attend_tell":
        return import_show_attend_tell(sd)
    if model == "show_tell":
        raise NotImplementedError(_SHOW_TELL)
    raise ValueError(f"unknown model {model!r}")


def apply_reference_checkpoint(cfg, model) -> bool:
    """Load ``cfg.torch_checkpoint`` into ``model`` in place: every trainable
    parameter, and the trunk when the file holds it. Returns whether it did
    (False for a decoder-only file, whose caller decides whether a random
    trunk deserves a warning)."""
    from show_and_tell_tpu_torch.ckpt.checkpoint import copy_into, load_trunk, trainable_state_dict

    if cfg.model == "show_tell":
        raise NotImplementedError(_SHOW_TELL)
    trainable, trunk = load_reference_checkpoint(cfg.torch_checkpoint)
    copy_into(trainable_state_dict(model), trainable, cfg.torch_checkpoint)
    if trunk is not None:
        load_trunk(model, trunk, cfg.torch_checkpoint)
    return trunk is not None


def load_encoder_weights(cfg, model) -> None:
    """Load ``cfg.encoder_weights``, a torchvision state dict of the
    ``cfg.encoder`` trunk, into ``model``'s frozen trunk in place."""
    from show_and_tell_tpu_torch.ckpt.checkpoint import load_trunk
    from show_and_tell_tpu_torch.models.encoders import load_torch_encoder

    trunk = trunk_state_dict(load_torch_encoder(cfg.encoder, cfg.encoder_weights)["convs"])
    load_trunk(model, trunk, cfg.encoder_weights)
