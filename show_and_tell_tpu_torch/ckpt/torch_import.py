"""Import reference-trained PyTorch checkpoints into the port.

A user of the reference code holds ``model-best.pth``, a state dict of its
``model2.ShowAttendTellModel`` or of its ``models.py`` ``EncoderCNN`` and
``DecoderRNN``. This renames and reshapes it onto the port's state dict, as
the JAX package's ``ckpt/torch_import.py`` builds its trees:

- ``nn.Linear`` stores ``weight [out, in]``; the port's dense ``w`` is
  ``[in, out]``: transposed;
- ``nn.LSTMCell`` and each layer ``l`` of ``nn.LSTM`` (``*_l{l}``) store
  ``weight_ih [4H, in]`` and ``weight_hh [4H, H]``, gate order (i, f, g, o),
  and two biases; the port's cell is one ``w [in+H, 4H]`` (x rows first,
  then h rows) and ``b = b_ih + b_hh``;
- ``image_att_w`` and ``embedding.weight`` keep their layout, ``weight_att``
  is flattened;
- the reference's ``encoder.<i>.*`` keys are torchvision's VGG16
  ``features.<i>.*`` for the 12 kept convs, already in the port's
  ``[out, in, kh, kw]`` layout; an ``EncoderCNN``'s ``resnet.*`` keys are
  torchvision's ResNet-152, its ``resnet.fc`` the projection and its ``bn``
  the BatchNorm with its running statistics.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from show_and_tell_tpu_torch.ckpt.convert import flatten_tree
from show_and_tell_tpu_torch.models.encoders import from_torch_resnet152, from_torch_vgg16

Tensors = Dict[str, torch.Tensor]


def _arr(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32)


def _tt(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(_arr(a)))


def _linear(sd: Dict, prefix: str, name: str, out: Tensors) -> None:
    out[f"{name}.w"] = _tt(_arr(sd[f"{prefix}.weight"]).T)
    out[f"{name}.b"] = _tt(sd[f"{prefix}.bias"])


def _lstm_cell(sd: Dict, prefix: str, name: str, out: Tensors, suffix: str = "") -> None:
    w_ih, w_hh = _arr(sd[f"{prefix}.weight_ih{suffix}"]), _arr(sd[f"{prefix}.weight_hh{suffix}"])
    out[f"{name}.w"] = _tt(np.concatenate([w_ih.T, w_hh.T], axis=0))
    out[f"{name}.b"] = _tt(_arr(sd[f"{prefix}.bias_ih{suffix}"]) + _arr(sd[f"{prefix}.bias_hh{suffix}"]))


def _strip_prefix(sd: Dict, prefix: str) -> Dict:
    n = len(prefix)
    return {k[n:]: v for k, v in sd.items() if k.startswith(prefix)}


def encoder_state_dict(tree) -> Tensors:
    """A trunk's tree (``models.encoders``) -> its state-dict entries, the
    tree's paths under ``encoder.``."""
    out: Tensors = {}
    flatten_tree(tree, "encoder.", out)
    return out


def trunk_state_dict(convs) -> Tensors:
    """The VGG16 trunk's ``[{"w", "b"}, ...]`` -> its state-dict entries."""
    return encoder_state_dict({"convs": convs})


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
    _lstm_cell(sd, "lstmcell", "lstm", out)
    _linear(sd, "context2out", "c2o", out)
    _linear(sd, "hidden2tout", "h2o", out)
    _linear(sd, "classifier", "classifier", out)
    enc = _strip_prefix(sd, "encoder.")
    trunk = None
    if enc:
        trunk = trunk_state_dict(from_torch_vgg16({f"features.{k}": v for k, v in enc.items()})["convs"])
    return out, trunk


def import_show_tell(sd: Dict, num_layers: int = 1) -> Tuple[Tensors, Optional[Tensors], Optional[Tensors]]:
    """``models.py`` ``EncoderCNN`` + ``DecoderRNN`` state dicts -> ``(trainable,
    batch_stats, trunk)``.

    The decoder's keys may be bare (``embed.weight``, ``lstm.*``,
    ``linear.*``) or under ``decoder.``, the encoder's bare (``resnet.*``,
    ``bn.*``) or under ``encoder.``: separate-module saves and a combined
    one. ``trainable`` holds the decoder, and the projection and the
    BatchNorm's scale and bias when the encoder's keys are there;
    ``batch_stats`` the BatchNorm's running {mean, var}, else None; ``trunk``
    the ResNet-152 when the whole ``resnet.*`` backbone is there, else
    None."""
    dec = _strip_prefix(sd, "decoder.") or sd
    enc = _strip_prefix(sd, "encoder.") or sd
    out: Tensors = {"embed": _tt(dec["embed.weight"])}
    for layer in range(num_layers):
        _lstm_cell(dec, "lstm", f"lstm.{layer}", out, f"_l{layer}")
    _linear(dec, "linear", "out", out)
    batch_stats = trunk = None
    if "resnet.fc.weight" in enc:
        _linear(enc, "resnet.fc", "proj", out)
    if "bn.weight" in enc:
        out["bn.scale"] = _tt(enc["bn.weight"])
        out["bn.bias"] = _tt(enc["bn.bias"])
        batch_stats = {"mean": _tt(enc["bn.running_mean"]), "var": _tt(enc["bn.running_var"])}
    if "resnet.conv1.weight" in enc:
        trunk = encoder_state_dict(from_torch_resnet152(_strip_prefix(enc, "resnet.")))
    return out, batch_stats, trunk


def load_reference_checkpoint(path: str, model: str = "show_attend_tell", num_layers: int = 1):
    """``model-best.pth`` of the reference trainer, loaded on the CPU with
    ``weights_only=True``; DataParallel's ``module.`` prefix is stripped.
    ``model='show_attend_tell'`` returns ``(trainable, trunk_or_None)``,
    ``model='show_tell'`` ``(trainable, batch_stats_or_None,
    trunk_or_None)``."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = {k: v.numpy() for k, v in sd.items()}
    if any(k.startswith("module.") for k in sd):
        sd = _strip_prefix(sd, "module.")
    if model == "show_attend_tell":
        return import_show_attend_tell(sd)
    if model == "show_tell":
        return import_show_tell(sd, num_layers=num_layers)
    raise ValueError(f"unknown model {model!r}")


def apply_reference_checkpoint(cfg, model) -> bool:
    """Load ``cfg.torch_checkpoint`` into ``model`` in place: for
    Show-Attend-Tell every trainable parameter, for Show-and-Tell what the
    file holds (the decoder, and the projection, the BatchNorm and its
    statistics when it holds the encoder's keys), and the trunk when the
    file holds it. Returns whether it did (False for a decoder-only file,
    whose caller decides whether a random trunk deserves a warning)."""
    from show_and_tell_tpu_torch.ckpt.checkpoint import check_like, copy_into, load_trunk, trainable_state_dict

    path = cfg.torch_checkpoint
    own = trainable_state_dict(model)
    if cfg.model == "show_tell":
        trainable, batch_stats, trunk = load_reference_checkpoint(path, "show_tell", cfg.num_layers)
        unknown = sorted(set(trainable) - set(own))
        if unknown:
            raise ValueError(f"{path}: names the model does not have: {unknown}")
        own = {k: own[k] for k in trainable}
        if batch_stats is not None:
            check_like(model.batch_stats, batch_stats, path)
    else:
        trainable, trunk = load_reference_checkpoint(path)
        batch_stats = None
    copy_into(own, trainable, path)
    if batch_stats is not None:
        copy_into(model.batch_stats, batch_stats, path)
    if trunk is not None:
        load_trunk(model, trunk, path)
    return trunk is not None


def load_encoder_weights(cfg, model) -> None:
    """Load ``cfg.encoder_weights``, a torchvision state dict of the model's
    trunk (``model.encoder_name``), into its frozen trunk in place."""
    from show_and_tell_tpu_torch.ckpt.checkpoint import load_trunk
    from show_and_tell_tpu_torch.models.encoders import load_torch_encoder

    trunk = encoder_state_dict(load_torch_encoder(model.encoder_name, cfg.encoder_weights))
    load_trunk(model, trunk, cfg.encoder_weights)
