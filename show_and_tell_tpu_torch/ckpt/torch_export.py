"""Export the port's weights as reference-format PyTorch checkpoints: the
inverse of ``ckpt.torch_import``, key for key the JAX package's
``ckpt/torch_export.py``.

- dense ``w [in, out]`` goes back to ``weight [out, in]``;
- the fused cell ``w [in+H, 4H]`` splits into ``weight_ih`` and
  ``weight_hh``; its one bias is written as ``bias_ih`` with a zero
  ``bias_hh`` (torch adds the two, so the cell is unchanged);
- the trunk, when the state dict holds it, becomes ``encoder.<i>.*`` at
  torchvision's VGG16 indices, so that the reference model loads the file
  strictly.

Only Show-Attend-Tell is ported; ``show_tell`` raises (ROADMAP.md A7). The
command-line exporter is ``cli/export_torch.py``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from show_and_tell_tpu_torch.models.encoders import _VGG_TORCH_IDX

_SHOW_TELL = "model 'show_tell' is not ported to PyTorch yet; see ROADMAP.md A7"


def _np(a) -> np.ndarray:
    if torch.is_tensor(a):
        a = a.detach().cpu().float().numpy()
    return np.asarray(a, dtype=np.float32)


def _t(a) -> np.ndarray:
    return np.ascontiguousarray(_np(a).T)


def _linear(sd: Mapping, name: str, prefix: str, out: Dict) -> None:
    out[f"{prefix}.weight"] = _t(sd[f"{name}.w"])
    out[f"{prefix}.bias"] = _np(sd[f"{name}.b"])


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
    w, b = _np(sd["lstm.w"]), _np(sd["lstm.b"])  # [in+H, 4H], [4H]
    n_in = w.shape[0] - b.shape[0] // 4
    out["lstmcell.weight_ih"] = _t(w[:n_in])
    out["lstmcell.weight_hh"] = _t(w[n_in:])
    out["lstmcell.bias_ih"] = b
    out["lstmcell.bias_hh"] = np.zeros_like(b)
    _linear(sd, "c2o", "context2out", out)
    _linear(sd, "h2o", "hidden2tout", out)
    _linear(sd, "classifier", "classifier", out)
    if "encoder.convs.0.w" in sd:
        for i, idx in enumerate(_VGG_TORCH_IDX):
            out[f"encoder.{idx}.weight"] = np.ascontiguousarray(_np(sd[f"encoder.convs.{i}.w"]))
            out[f"encoder.{idx}.bias"] = _np(sd[f"encoder.convs.{i}.b"])
    return out


def save_state_dict(sd: Dict[str, np.ndarray], path: str) -> None:
    """Write a ``torch.save`` checkpoint that ``torch.load(path,
    weights_only=True)`` and the reference's plain ``torch.load`` read."""
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, path)


def export_checkpoint(cfg, state_dict: Mapping[str, torch.Tensor], path: str) -> None:
    """One-call export by ``cfg.model``."""
    if cfg.model == "show_tell":
        raise NotImplementedError(_SHOW_TELL)
    if cfg.model != "show_attend_tell":
        raise ValueError(f"unknown model {cfg.model!r}")
    save_state_dict(export_show_attend_tell(state_dict), path)
