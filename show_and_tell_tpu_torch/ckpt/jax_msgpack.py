"""Reader of the JAX package's checkpoints, without flax: the migration path
from a JAX-trained run to the port.

The JAX package writes ``model-best.msgpack`` and ``state-last.msgpack`` with
``flax.serialization.to_bytes``: a msgpack map of the state's fields, in
which

- an array is ext type 1 holding a nested msgpack ``(shape, dtype name,
  C-order bytes)``; a numpy scalar is ext type 3 with the same payload;
- ``bfloat16`` has no numpy dtype: it is read as ``uint16`` and viewed as
  ``torch.bfloat16``;
- an array over flax's chunk size (2**30 bytes) arrives as a map
  ``{"__msgpack_chunked_array__": True, "shape": {...}, "chunks": {...}}``
  (tuples become maps keyed "0", "1", ...) and is put back together here;
- a tuple of optimizer states is a map keyed "0", "1", ....

``msgpack`` is imported inside the reader, so only reading a JAX file needs
it. Arrays come back as torch tensors on the CPU; the parameter names cross
by ``ckpt.convert.from_jax_trainable``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from show_and_tell_tpu_torch.ckpt.convert import from_jax_trainable

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"


def _ndarray(data: bytes) -> torch.Tensor:
    import msgpack

    shape, name, buf = msgpack.unpackb(data, raw=True)
    if name == b"bfloat16":
        a = np.frombuffer(buf, dtype=np.uint16).copy().reshape(shape)
        return torch.from_numpy(a).view(torch.bfloat16)
    a = np.frombuffer(buf, dtype=np.dtype(name.decode())).copy().reshape(shape)
    return torch.from_numpy(a)


def _ext_hook(code: int, data: bytes):
    import msgpack

    if code == _EXT_NDARRAY:
        return _ndarray(data)
    if code == _EXT_NPSCALAR:
        return _ndarray(data).item()
    return msgpack.ExtType(code, data)


def _tuple(d: Dict[str, Any]) -> list:
    return [d[str(i)] for i in range(len(d))]


def _unchunk(tree: Any) -> Any:
    if isinstance(tree, dict):
        if tree.get(_CHUNKED):
            shape = _tuple(tree["shape"])
            return torch.cat([c.reshape(-1) for c in _tuple(tree["chunks"])]).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def read_msgpack(path: str) -> Any:
    """The state dict of a flax msgpack file: nested dicts of tensors,
    Python scalars and None."""
    import msgpack

    with open(path, "rb") as f:
        tree = msgpack.unpackb(f.read(), ext_hook=_ext_hook, raw=False)
    return _unchunk(tree)


def _stats(tree) -> Optional[Dict[str, torch.Tensor]]:
    """A file's ``batch_stats``: Show-and-Tell's {mean, var} as fp32, or
    None (Show-Attend-Tell has none)."""
    return None if tree is None else {k: tree[k].float() for k in ("mean", "var")}


def load_jax_best(path: str) -> Tuple[Dict[str, torch.Tensor], Optional[Dict[str, torch.Tensor]]]:
    """``model-best.msgpack`` -> ``(trainable state dict, batch_stats)``."""
    d = read_msgpack(path)
    return from_jax_trainable(d["params"]), _stats(d.get("batch_stats"))


def load_jax_train_state(path: str) -> Dict[str, Any]:
    """``state-last.msgpack`` -> the port's train-state checkpoint layout
    (``ckpt.checkpoint.save_train_state``):

    - ``params``, and ``ema_params`` when the file has that field (None
      when it was saved without an average);
    - ``batch_stats``: Show-and-Tell's {mean, var}, else None;
    - ``opt_state``: Adam's ``count``, ``mu``, ``nu`` (``opt_state/1`` of
      the clip, Adam, scale chain), and under gradient accumulation
      (``optax.MultiSteps``, whose Adam state sits in ``inner_opt_state``)
      ``mini_step`` and ``acc_grads``;
    - ``step``."""
    d = read_msgpack(path)
    opt = d["opt_state"]
    multi = "inner_opt_state" in opt
    adam = (opt["inner_opt_state"] if multi else opt)["1"]
    opt_state: Dict[str, Any] = {
        "count": int(adam["count"]),
        "mu": from_jax_trainable(adam["mu"]),
        "nu": from_jax_trainable(adam["nu"]),
    }
    if multi:
        opt_state["mini_step"] = int(opt["mini_step"])
        opt_state["acc_grads"] = from_jax_trainable(opt["acc_grads"])
    state: Dict[str, Any] = {
        "params": from_jax_trainable(d["params"]),
        "opt_state": opt_state,
        "step": int(d["step"]),
        "batch_stats": _stats(d.get("batch_stats")),
    }
    if "ema_params" in d:
        ema = d["ema_params"]
        state["ema_params"] = None if ema is None else from_jax_trainable(ema)
    return state
