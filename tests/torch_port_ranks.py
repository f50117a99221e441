"""Rank workers of the port's multi-device tests (``test_torch_port_parallel.py``).

    results = run("train", world=2, tmp=tmp_path, spec={...})

``run`` starts ``world`` processes (``torch.multiprocessing``, the spawn
method), each a rank of a gloo process group that meets through a
``file://`` store under ``tmp`` (so parallel test runs never share a port),
calls the named worker here with its rank and the spec, and returns each
rank's result, read back from a pickle the rank wrote under ``tmp``. This
module imports the port and nothing of JAX, so the children stay light; the
weights and batches come in the spec as numpy arrays, and the results go
back as numpy arrays. Every worker runs on one thread, on the CPU.

Workers:
- ``train``: for each case of ``spec["cases"]``, a mesh of (``world``,
  ``mp``), the model placed on it, ``steps`` train steps on its rows of one
  global batch; returns the losses, the gathered params and the batch
  statistics, and the first forward's gathered logits;
- ``serve``: a ``Captioner`` over a ``world``-rank data mesh, every mode
  (``both`` runs ``train`` and then ``serve``);
- ``resume``: a ``Trainer`` at ``model_parallel`` over a ``cli.main`` run's
  ``state-last.pt``, run on; returns the losses and the gathered params.
"""

from __future__ import annotations

import contextlib
import os
import pickle
from typing import Any, Dict, List

import numpy as np
import torch
import torch.distributed as dist

from show_and_tell_tpu_torch import ckpt
from show_and_tell_tpu_torch.config import Config
from show_and_tell_tpu_torch.models import encoders
from show_and_tell_tpu_torch.models.registry import build_model
from show_and_tell_tpu_torch.parallel import distributed
from show_and_tell_tpu_torch.parallel import mesh as mesh_lib
from show_and_tell_tpu_torch.serve import Captioner
from show_and_tell_tpu_torch.train.step import make_train_state, make_train_step
from show_and_tell_tpu_torch.utils.rng import KeyChain
from show_and_tell_tpu_torch.utils.vocab import Vocabulary


def run(worker: str, world: int, tmp: str, spec: Dict[str, Any]) -> List[Any]:
    """Each rank's result of ``worker(rank, world, spec)``."""
    os.makedirs(tmp, exist_ok=True)
    store = os.path.join(tmp, f"store.{worker}.{world}")
    torch.multiprocessing.spawn(_rank_main, args=(worker, world, store, tmp, spec), nprocs=world, join=True)
    out = []
    for r in range(world):
        with open(os.path.join(tmp, f"{worker}.{world}.{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _rank_main(rank, worker, world, store, tmp, spec):
    torch.set_num_threads(1)
    distributed.initialize(f"file://{store}", num_processes=world, process_id=rank, backend="gloo")
    try:
        result = globals()[worker](rank, world, spec)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"{worker}.{world}.{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


@contextlib.contextmanager
def no_trunk():
    """Models built without a trunk, for the cases fed features (a random
    ResNet-152 costs seconds)."""
    real = encoders.init_encoder
    encoders.init_encoder = lambda name, generator=None, dtype=torch.float32: {}
    try:
        yield
    finally:
        encoders.init_encoder = real


STATS = {"bn.mean": "mean", "bn.var": "var"}  # the statistics' names in a state dict


def model_with(cfg: Config, V: int, weights: Dict[str, np.ndarray], trunk: bool = True):
    """The port's model (its own seeded trunk, or none) holding the given
    trainable weights and statistics (numpy, by state-dict name)."""
    with contextlib.nullcontext() if trunk else no_trunk():
        model = build_model(cfg, V, device="cpu", generator=torch.Generator().manual_seed(0))
    sd = {k: torch.from_numpy(np.asarray(v)) for k, v in weights.items()}
    ckpt.copy_into(ckpt.trainable_state_dict(model), {k: v for k, v in sd.items() if k not in STATS}, "trainable")
    if model.batch_stats is not None:
        ckpt.copy_into(model.batch_stats, {STATS[k]: v for k, v in sd.items() if k in STATS}, "stats")
    return model


def _numpy(tree):
    return None if tree is None else {k: v.detach().float().cpu().numpy().copy() for k, v in tree.items()}


def train_case(case: Dict[str, Any], world: int) -> Dict[str, Any]:
    """One case of ``train``: a mesh of (world, case["mp"]) (world 1 without
    a process group is one device), its steps and figures."""
    cfg = Config(**case["cfg"])
    model = model_with(cfg, case["V"], case["weights"], trunk=case.get("trunk", False))
    mesh = mesh_lib.make_mesh(world, case.get("mp", 1), device="cpu")
    mesh_lib.replicate(mesh, {**ckpt.trainable_state_dict(model), **(model.batch_stats or {})})
    mesh_lib.place_params(mesh, model)
    shardings = mesh_lib.model_shardings(model)
    state, step = make_train_state(cfg, model), make_train_step(model, cfg)
    batch = mesh_lib.shard_batch(mesh, {k: torch.from_numpy(v) for k, v in case["batch"].items()})
    out: Dict[str, Any] = {"losses": [], "shardings": shardings}
    with torch.no_grad():  # the first forward's logits, gathered over the data axis
        feats = step.features(batch, KeyChain(cfg.random_seed).generator("train", 1, 1))
        if hasattr(model, "encode"):
            logits, _ = model.decode_train(model.encode(feats, train=False)[0], batch["captions"], batch["lengths"])
        else:
            logits = model.decode_train(feats, batch["captions"], batch["lengths"])[0]
        if mesh.distributed:
            from show_and_tell_tpu_torch.parallel.collectives import all_gather

            logits = all_gather(logits, mesh.data_group, mesh.data_index, mesh.data)
        out["logits"] = logits.numpy()
    for i in range(case.get("steps", 3)):
        gen = KeyChain(cfg.random_seed).generator("train", 1, i + 1)
        state, metrics = step(state, batch, case.get("lr", 1e-3), case.get("ss_prob", 0.0), gen)
        out["losses"].append(float(metrics["loss"]))
        out.setdefault("tokens", float(metrics["tokens"]))
    out["params"] = _numpy(mesh_lib.gather_params(mesh, state.params, shardings))
    out["local_shapes"] = {k: tuple(v.shape) for k, v in state.params.items()}
    out["stats"] = _numpy(state.batch_stats)
    return out


def train(rank: int, world: int, spec: Dict[str, Any]) -> List[Dict[str, Any]]:
    return [train_case(case, world) for case in spec["cases"]]


def serve(rank: int, world: int, spec: Dict[str, Any]) -> Dict[str, Any]:
    """A Captioner over a data mesh of every rank: captions by beam, greedy
    and sample, n-best, attention maps; the bucket rules."""
    cfg = Config(**spec["cfg"])
    vocab = Vocabulary.from_words(spec["words"])
    mesh = mesh_lib.make_mesh(world, 1, device="cpu")
    model = model_with(cfg, len(vocab), spec["weights"])
    cap = Captioner(cfg, model, None, vocab, device="cpu", bucket_sizes=spec["buckets"], mesh=mesh)
    images = spec["images"]
    out: Dict[str, Any] = {mode: cap.caption_images(images, mode=mode) for mode in ("beam", "greedy", "sample")}
    nbest = cap.caption_nbest(images)
    out["nbest"] = [[c for c, _ in alts] for alts in nbest]
    out["nbest_scores"] = np.array([[s for _, s in alts] for alts in nbest])
    out["attention"] = cap.caption_with_attention(images)
    try:
        Captioner(cfg, model, None, vocab, device="cpu", bucket_sizes=(3,), mesh=mesh)
        out["odd_bucket"] = "accepted"
    except ValueError as e:
        out["odd_bucket"] = str(e)
    auto = Captioner(cfg, model, None, vocab, device="cpu", mesh=mesh)
    out["auto_buckets"] = list(auto.bucket_sizes)
    out["auto_greedy"] = auto.caption_images(images[:3], mode="greedy")
    return out


def both(rank: int, world: int, spec: Dict[str, Any]) -> Dict[str, Any]:
    return {"train": train(rank, world, spec), "serve": serve(rank, world, spec["serve"])}


def resume(rank: int, world: int, spec: Dict[str, Any]) -> Dict[str, Any]:
    """A Trainer resuming ``spec["cfg"]``'s ``start_from`` on its mesh, fed
    ``spec["batches"]``: its params as restored (gathered, before the first
    step), its losses and its gathered params at the end."""
    from show_and_tell_tpu_torch.train.trainer import Trainer

    cfg = Config(**spec["cfg"])
    model = build_model(cfg, spec["V"], device="cpu", generator=KeyChain(cfg.random_seed).generator("init"))
    trainer = Trainer(cfg, model, spec["batches"])
    losses, restored = [], {}
    real = trainer.train_step

    def recording(*a):
        if not restored:
            restored.update(_numpy(mesh_lib.gather_params(trainer.mesh, trainer.state.params, trainer.shardings)))
        state, metrics = real(*a)
        losses.append(float(metrics["loss"]))
        return state, metrics

    trainer.train_step = recording
    trainer.train()
    return {"losses": losses, "step": trainer.state.step, "restored": restored,
            "params": _numpy(mesh_lib.gather_params(trainer.mesh, trainer.state.params, trainer.shardings)),
            "local_shapes": {k: tuple(v.shape) for k, v in trainer.state.params.items()}}
