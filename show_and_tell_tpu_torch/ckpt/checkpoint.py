"""Checkpoints: the best model, the info histories and the full train state.

The layout of an experiment directory is the JAX package's:

- ``infos.json`` and ``infos-best.json``, written by the same JSON rules;
- ``model-best.pt``: ``torch.save`` of ``{"params": <trainable state dict>,
  "batch_stats": <{mean, var}>}``, the batch statistics being Show-and-Tell's
  BatchNorm running statistics and None for Show-Attend-Tell (the JAX
  package writes ``model-best.msgpack``);
- ``state-last.pt``: the whole ``TrainState``, so that a resumed run goes on
  bit for bit: the params, Adam's ``count``, ``mu`` and ``nu``, under
  gradient accumulation ``mini_step`` and ``acc_grads``, ``step``,
  ``ema_params`` and ``batch_stats`` (the JAX package writes
  ``state-last.msgpack``).

Every write goes to a ``.tmp`` file first and is published by
``os.replace``, so a crash never leaves a torn file. The loaders read the
port's file when it exists, else the JAX package's (``ckpt.jax_msgpack``),
and load with ``weights_only=True``.

Loading copies into the tensors of a template: a ``TrainState``'s params are
the model's own ``Parameter``s, which the step updates in place, so a loader
that swapped in new tensors would detach the model from its state. Every
name and shape is checked before the first copy.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

log = logging.getLogger(__name__)

INFOS = "infos.json"
INFOS_BEST = "infos-best.json"
MODEL_BEST = "model-best.pt"
STATE_LAST = "state-last.pt"
JAX_MODEL_BEST = "model-best.msgpack"
JAX_STATE_LAST = "state-last.msgpack"

Tensors = Dict[str, torch.Tensor]


def _jsonable(obj):
    """numpy and torch scalars and arrays to native JSON types; anything else
    raises, as a silently stringified ``best_val_score`` would break the
    resumed run's comparisons."""
    if hasattr(obj, "item") and getattr(obj, "ndim", 1) == 0:
        return obj.item()
    if hasattr(obj, "tolist"):
        return obj.tolist()
    raise TypeError(f"not JSON-serializable in infos: {type(obj).__name__}")


def _publish(path: str, write) -> str:
    tmp = path + ".tmp"
    write(tmp)
    os.replace(tmp, path)
    return path


def save_infos(expr_dir: str, infos: Dict, best: bool = False) -> str:
    os.makedirs(expr_dir, exist_ok=True)

    def write(tmp):
        with open(tmp, "w") as f:
            json.dump(infos, f, indent=1, default=_jsonable)

    return _publish(os.path.join(expr_dir, INFOS_BEST if best else INFOS), write)


def load_infos(expr_dir: str, best: bool = False) -> Optional[Dict]:
    path = os.path.join(expr_dir, INFOS_BEST if best else INFOS)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def trainable_state_dict(model) -> Tensors:
    """The model's trainable ``Parameter``s by state-dict name: the params
    of a checkpoint, and a template to load one into."""
    return {n: p for n, p in model.named_parameters() if p.requires_grad}


def _cpu(tree: Optional[Mapping[str, torch.Tensor]]) -> Optional[Tensors]:
    return None if tree is None else {k: v.detach().cpu() for k, v in tree.items()}


def check_like(template: Mapping[str, torch.Tensor], source: Mapping[str, torch.Tensor], what: str) -> None:
    """Raise unless ``source`` holds the template's names with its shapes."""
    missing = sorted(set(template) - set(source))
    extra = sorted(set(source) - set(template))
    if missing or extra:
        raise ValueError(f"{what}: names differ from the template: missing {missing}, unexpected {extra}")
    bad = [f"{k} {tuple(source[k].shape)} != {tuple(t.shape)}" for k, t in template.items()
           if tuple(source[k].shape) != tuple(t.shape)]
    if bad:
        raise ValueError(f"{what}: shapes differ from the template: {bad}")


@torch.no_grad()
def _copy(template: Mapping[str, torch.Tensor], source: Mapping[str, torch.Tensor]) -> None:
    for k, t in template.items():
        t.copy_(source[k])


def copy_into(template: Mapping[str, torch.Tensor], source: Mapping[str, torch.Tensor], what: str) -> None:
    """Copy ``source`` into ``template``'s tensors in place, after
    ``check_like``."""
    check_like(template, source, what)
    _copy(template, source)


def load_trunk(model, trunk: Mapping[str, torch.Tensor], what: str) -> None:
    """Copy a trunk's state-dict entries (``encoder.convs.<i>.{w,b}``) into
    ``model``'s frozen trunk in place; every conv of the trunk must be
    there."""
    template = {n: p for n, p in model.named_parameters() if n.startswith("encoder.")}
    copy_into(template, trunk, what)


def save_best(expr_dir: str, params: Mapping[str, torch.Tensor], batch_stats: Any, infos: Dict) -> str:
    """Write model-best and infos-best. The weights are written first under
    a temporary name, then infos-best is published, then the weights: the
    slow work is done before the two renames, so a crash pairs new weights
    with old infos only in the instant between them."""
    os.makedirs(expr_dir, exist_ok=True)
    path = os.path.join(expr_dir, MODEL_BEST)
    tmp = path + ".tmp"
    torch.save({"params": _cpu(params), "batch_stats": _cpu(batch_stats)}, tmp)
    save_infos(expr_dir, infos, best=True)
    os.replace(tmp, path)
    return path


def _stats_pair(template: Optional[Mapping[str, torch.Tensor]], stats, path: str, what: str):
    """(template, source) of the batch statistics to copy, after checking
    that a template's statistics are in the file; None without a
    template."""
    if template is None:
        return None
    if stats is None:
        raise ValueError(f"{path}: holds no {what} (a model with BatchNorm statistics needs them)")
    check_like(template, stats, f"{path}: {what}")
    return template, stats


def load_best_params(
    expr_dir: str,
    params_template: Mapping[str, torch.Tensor],
    batch_stats_template: Optional[Mapping[str, torch.Tensor]] = None,
) -> Optional[Tuple[Mapping[str, torch.Tensor], Any]]:
    """Copy the best params into ``params_template``, and the batch
    statistics into ``batch_stats_template`` when one is given (a
    Show-and-Tell model's ``batch_stats``, its own buffers); returns
    ``(params, batch_stats)``, the file's statistics without a template. None
    when ``expr_dir`` holds neither the port's ``model-best.pt`` nor the JAX
    package's ``model-best.msgpack``."""
    path = os.path.join(expr_dir, MODEL_BEST)
    jax_path = os.path.join(expr_dir, JAX_MODEL_BEST)
    if os.path.exists(path):
        blob = torch.load(path, map_location="cpu", weights_only=True)
        params, batch_stats = blob["params"], blob["batch_stats"]
    elif os.path.exists(jax_path):
        from show_and_tell_tpu_torch.ckpt.jax_msgpack import load_jax_best

        path = jax_path
        params, batch_stats = load_jax_best(jax_path)
    else:
        return None
    log.info("reading the best params from %s", path)
    check_like(params_template, params, path)
    stats = _stats_pair(batch_stats_template, batch_stats, path, "batch_stats")
    _copy(params_template, params)
    if stats is not None:
        _copy(*stats)
        batch_stats = batch_stats_template
    return params_template, batch_stats


def _state_blob(state) -> Dict[str, Any]:
    opt = state.opt_state
    opt_blob: Dict[str, Any] = {"count": int(opt["count"]), "mu": _cpu(opt["mu"]), "nu": _cpu(opt["nu"])}
    if "acc_grads" in opt:
        opt_blob.update(mini_step=int(opt["mini_step"]), acc_grads=_cpu(opt["acc_grads"]))
    return {"params": _cpu(state.params), "opt_state": opt_blob, "step": int(state.step),
            "ema_params": _cpu(state.ema_params), "batch_stats": _cpu(state.batch_stats)}


def save_train_state(expr_dir: str, state) -> str:
    """Write ``state-last.pt`` from a ``train.step.TrainState``."""
    os.makedirs(expr_dir, exist_ok=True)
    blob = _state_blob(state)
    return _publish(os.path.join(expr_dir, STATE_LAST), lambda tmp: torch.save(blob, tmp))


def load_train_state(expr_dir: str, state_template):
    """Restore ``state-last.pt`` (else the JAX package's
    ``state-last.msgpack``) into ``state_template``, a ``TrainState`` made
    by ``make_train_state`` for the same config, its batch statistics too
    when it has them. Returns it, or None when neither file exists.

    The EMA follows the JAX package's three rules:
    - a file without an average (older, or saved with ``ema_decay`` 0) and
      a template with one: the average starts from the restored params;
    - a template without an average: none is restored, and an average in the
      file is dropped (the step would never update it);
    - both: the file's average is restored.
    """
    path = os.path.join(expr_dir, STATE_LAST)
    jax_path = os.path.join(expr_dir, JAX_STATE_LAST)
    if os.path.exists(path):
        blob = torch.load(path, map_location="cpu", weights_only=True)
    elif os.path.exists(jax_path):
        from show_and_tell_tpu_torch.ckpt.jax_msgpack import load_jax_train_state

        path, blob = jax_path, load_jax_train_state(jax_path)
    else:
        return None
    log.info("reading the train state from %s", path)
    state = state_template
    opt, opt_blob = state.opt_state, blob["opt_state"]
    if ("acc_grads" in opt) != ("acc_grads" in opt_blob):
        raise ValueError(
            f"{path}: gradient accumulation differs: the file "
            f"{'has' if 'acc_grads' in opt_blob else 'has no'} accumulation state, the template "
            f"{'has' if 'acc_grads' in opt else 'has none'} (grad_accum_steps)"
        )
    ema = blob.get("ema_params")
    if state.ema_params is not None and ema is None:
        ema = blob["params"]
    # every check before the first copy
    pairs = [(state.params, blob["params"], "params"), (opt["mu"], opt_blob["mu"], "mu"),
             (opt["nu"], opt_blob["nu"], "nu")]
    if "acc_grads" in opt:
        pairs.append((opt["acc_grads"], opt_blob["acc_grads"], "acc_grads"))
    if state.ema_params is not None:
        pairs.append((state.ema_params, ema, "ema_params"))
    for template, source, what in pairs:
        check_like(template, source, f"{path}: {what}")
    stats = _stats_pair(state.batch_stats, blob.get("batch_stats"), path, "batch_stats")
    for template, source, _ in pairs:
        _copy(template, source)
    if stats is not None:
        _copy(*stats)
    opt["count"] = int(opt_blob["count"])
    if "acc_grads" in opt:
        opt["mini_step"] = int(opt_blob["mini_step"])
    state.step = int(blob["step"])
    return state
