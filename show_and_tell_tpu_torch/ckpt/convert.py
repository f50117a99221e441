"""The weights bridge between the JAX package's parameter trees and the port.

A state-dict name is the leaf's path in the JAX tree, joined by dots: the
Show-Attend-Tell ``{"att": {"w_img": ...}, "lstm": {"w", "b"}, ...}`` gives
``att.w_img`` and ``lstm.w``; the Show-and-Tell ``{"proj", "bn": {scale,
bias}, "embed", "lstm": [{w, b}, ...], "out"}`` gives ``bn.scale`` and
``lstm.0.w``. A list, or flax's map of it keyed "0", "1", ..., becomes
numbered names. So

- ``from_jax_trainable(trainable)`` gives the trainable state dict, all that
  a JAX checkpoint holds besides the batch statistics, and
  ``to_jax_trainable`` is its inverse;
- ``from_jax_params(trainable, frozen, batch_stats)`` gives the whole state
  dict for ``model.load_state_dict``: the trunk under ``encoder.`` and, for
  Show-and-Tell, the BatchNorm's running ``{mean, var}`` as ``bn.mean`` and
  ``bn.var``.

Layouts stay as they are, except that conv weights (the trunk's 4-D leaves)
move from HWIO ``[kh, kw, cin, cout]`` to PyTorch's ``[cout, cin, kh, kw]``.
The fused LSTM ``w [I+H, 4H]`` (gate order i, f, g, o, one bias) is kept
whole, because the cell kernel consumes it.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

Params = Dict


def _t(a) -> torch.Tensor:
    if torch.is_tensor(a):
        return a.detach().to(torch.float32).contiguous()
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def flatten_tree(tree: Any, prefix: str, out: Dict[str, torch.Tensor], hwio: bool = False) -> None:
    """Put ``tree``'s leaves into ``out`` as fp32 tensors under their
    dotted paths after ``prefix``; with ``hwio`` its 4-D leaves move from
    HWIO to [cout, cin, kh, kw]."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        t = _t(tree)
        if hwio and t.dim() == 4:
            t = t.permute(3, 2, 0, 1).contiguous()
        out[prefix[:-1]] = t
        return
    for k, v in items:
        flatten_tree(v, f"{prefix}{k}.", out, hwio)


def from_jax_trainable(trainable: Params) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    flatten_tree(trainable, "", sd)
    return sd


def _lists(tree: Any) -> Any:
    """Nested dicts whose keys are all "0", "1", ... become lists."""
    if not isinstance(tree, dict):
        return tree
    tree = {k: _lists(v) for k, v in tree.items()}
    if tree and all(k.isdigit() for k in tree):
        return [tree[str(i)] for i in range(len(tree))]
    return tree


def to_jax_trainable(sd: Dict[str, torch.Tensor]) -> Params:
    """A state dict (or any dict keyed by the trainable parameters' names,
    such as the Adam moments) -> the JAX trainable tree, fp32 numpy."""
    tree: Dict[str, Any] = {}
    for name, v in sd.items():
        *path, leaf = name.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v.detach().cpu().float().numpy()
    return _lists(tree)


def from_jax_params(
    trainable: Params, frozen: Params, batch_stats: Optional[Params] = None
) -> Dict[str, torch.Tensor]:
    sd = from_jax_trainable(trainable)
    flatten_tree(frozen, "encoder.", sd, hwio=True)
    if batch_stats is not None:
        sd["bn.mean"] = _t(batch_stats["mean"])
        sd["bn.var"] = _t(batch_stats["var"])
    return sd


def from_jax_quantized(tree: Any) -> Params:
    """The JAX package's calibrated int8 trunk (``models/quantize.py``: numpy
    or JAX arrays, or the tensors of a msgpack file, with lists as maps
    keyed "0", "1", ...) -> the port's tree: the same keys and dtypes; the
    float convs' HWIO weights as [cout, cin, kh, kw]; each int8 ``wq``
    keeping its HWIO shape, laid out so that its [kh*kw*cin, cout] reshape
    is column-major, the layout the port's int8 GEMM reads."""
    from show_and_tell_tpu_torch.models.quantize import gemm_layout

    tree = _lists(tree)
    if isinstance(tree, dict):
        return {k: from_jax_quantized(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [from_jax_quantized(v) for v in tree]
    t = tree.detach().clone() if torch.is_tensor(tree) else torch.from_numpy(np.array(tree, order="C"))
    if t.dim() == 4 and t.dtype == torch.int8:
        t = gemm_layout(t)
    elif t.dim() == 4:
        t = t.permute(3, 2, 0, 1).contiguous()
    return t
