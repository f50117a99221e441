"""Export the port's weights as reference-format PyTorch checkpoints: the
inverse of ``ckpt.torch_import``, key for key the JAX package's
``ckpt/torch_export.py``.

- dense ``w [in, out]`` goes back to ``weight [out, in]``;
- the fused cell ``w [in+H, 4H]`` splits into ``weight_ih`` and
  ``weight_hh``; its one bias is written as ``bias_ih`` with a zero
  ``bias_hh`` (torch adds the two, so the cell is unchanged);
- Show-Attend-Tell: the trunk, when the state dict holds it, becomes
  ``encoder.<i>.*`` at torchvision's VGG16 indices, so that the reference
  model loads the file strictly;
- Show-and-Tell: one dict with the ``decoder.`` and ``encoder.`` prefixes of
  a combined save (``split_show_tell`` gives the two modules' dicts). The
  decoder's loads strictly into ``DecoderRNN``; the encoder's carries the
  trained parts, ``resnet.fc`` and ``bn`` with its running statistics, and
  loads with ``strict=False`` over a torchvision ResNet-152, as the
  reference builds ``EncoderCNN``.

The command-line exporter is ``cli/export_torch.py``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from show_and_tell_tpu_torch.models.encoders import _VGG_TORCH_IDX


def _np(a) -> np.ndarray:
    if torch.is_tensor(a):
        a = a.detach().cpu().float().numpy()
    return np.asarray(a, dtype=np.float32)


def _t(a) -> np.ndarray:
    return np.ascontiguousarray(_np(a).T)


def _linear(sd: Mapping, name: str, prefix: str, out: Dict) -> None:
    out[f"{prefix}.weight"] = _t(sd[f"{name}.w"])
    out[f"{prefix}.bias"] = _np(sd[f"{name}.b"])


def _lstm_cell(sd: Mapping, name: str, prefix: str, out: Dict, suffix: str = "") -> None:
    w, b = _np(sd[f"{name}.w"]), _np(sd[f"{name}.b"])  # [in+H, 4H], [4H]
    n_in = w.shape[0] - b.shape[0] // 4
    out[f"{prefix}.weight_ih{suffix}"] = _t(w[:n_in])
    out[f"{prefix}.weight_hh{suffix}"] = _t(w[n_in:])
    out[f"{prefix}.bias_ih{suffix}"] = b
    out[f"{prefix}.bias_hh{suffix}"] = np.zeros_like(b)


def export_show_attend_tell(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """A port state dict (``model.state_dict()``, or the trainable params
    alone) -> a ``model2.ShowAttendTellModel`` state dict as fp32 numpy; the
    ``encoder.*`` keys only when ``state_dict`` holds the trunk."""
    sd = state_dict
    out: Dict[str, np.ndarray] = {
        "image_att_w": _np(sd["att.w_img"]),
        "weight_hh.weight": _t(sd["att.w_hh"]),
        "weight_hh.bias": _np(sd["att.b_hh"]),
        "weight_att": _np(sd["att.w_att"]).reshape(-1, 1),
    }
    _linear(sd, "init_h", "init_hidden", out)
    _linear(sd, "init_c", "init_memory", out)
    out["embedding.weight"] = _np(sd["embed"])
    _lstm_cell(sd, "lstm", "lstmcell", out)
    _linear(sd, "c2o", "context2out", out)
    _linear(sd, "h2o", "hidden2tout", out)
    _linear(sd, "classifier", "classifier", out)
    if "encoder.convs.0.w" in sd:
        for i, idx in enumerate(_VGG_TORCH_IDX):
            out[f"encoder.{idx}.weight"] = np.ascontiguousarray(_np(sd[f"encoder.convs.{i}.w"]))
            out[f"encoder.{idx}.bias"] = _np(sd[f"encoder.convs.{i}.b"])
    return out


def export_show_tell(state_dict: Mapping[str, torch.Tensor], num_layers: int = 1) -> Dict[str, np.ndarray]:
    """A Show-and-Tell state dict (``model.state_dict()``, or the trainable
    params alone) -> the combined ``decoder.`` / ``encoder.`` state dict as
    numpy. The BatchNorm's running statistics come from ``bn.mean`` and
    ``bn.var``, zeros and ones without them."""
    sd = state_dict
    out: Dict[str, np.ndarray] = {"decoder.embed.weight": _np(sd["embed"])}
    for layer in range(num_layers):
        _lstm_cell(sd, f"lstm.{layer}", "decoder.lstm", out, f"_l{layer}")
    _linear(sd, "out", "decoder.linear", out)
    if "proj.w" in sd:
        _linear(sd, "proj", "encoder.resnet.fc", out)
    if "bn.scale" in sd:
        out["encoder.bn.weight"] = _np(sd["bn.scale"])
        out["encoder.bn.bias"] = _np(sd["bn.bias"])
        E = out["encoder.bn.weight"].shape[0]
        out["encoder.bn.running_mean"] = _np(sd["bn.mean"]) if "bn.mean" in sd else np.zeros(E, np.float32)
        out["encoder.bn.running_var"] = _np(sd["bn.var"]) if "bn.var" in sd else np.ones(E, np.float32)
        out["encoder.bn.num_batches_tracked"] = np.asarray(0, np.int64)
    return out


def split_show_tell(sd: Dict[str, np.ndarray]):
    """A combined export -> ``(decoder_sd, encoder_sd)`` for the reference's
    separate ``DecoderRNN`` and ``EncoderCNN`` (load the encoder's with
    ``strict=False``: the torchvision trunk supplies the rest)."""
    dec = {k[len("decoder."):]: v for k, v in sd.items() if k.startswith("decoder.")}
    enc = {k[len("encoder."):]: v for k, v in sd.items() if k.startswith("encoder.")}
    return dec, enc


def save_state_dict(sd: Dict[str, np.ndarray], path: str) -> None:
    """Write a ``torch.save`` checkpoint that ``torch.load(path,
    weights_only=True)`` and the reference's plain ``torch.load`` read."""
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, path)


def export_checkpoint(cfg, state_dict: Mapping[str, torch.Tensor], path: str) -> None:
    """One-call export by ``cfg.model``."""
    if cfg.model == "show_tell":
        sd = export_show_tell(state_dict, cfg.num_layers)
    elif cfg.model == "show_attend_tell":
        sd = export_show_attend_tell(state_dict)
    else:
        raise ValueError(f"unknown model {cfg.model!r}")
    save_state_dict(sd, path)
