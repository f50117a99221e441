"""Training runtime: the reference ``Trainer`` (train.py:20-197) over the
port's ``TrainStep`` on one device.

Epoch and iteration semantics are the JAX package's:
- epochs run 1..max_epochs (train.py:97); resume skips completed epochs and
  iterations from the saved infos (train.py:70-85,98-99,119-120);
- per-epoch LR step decay and scheduled sampling (``train/schedule.py``);
- loss and perplexity logged every ``log_step`` (train.py:151-154), the
  loss fetched one log window late so that the host does not wait on the
  step it just queued;
- every ``save_checkpoint_every`` total iterations: validation, histories,
  the best-checkpoint gate on CIDEr (language_eval == 1) or -val_loss
  (train.py:156-196); SIGTERM/SIGINT (``train/preempt.py``) finish the step
  and save the full train state for ``start_from``.

Against the JAX trainer:
- one device: ``multihost``, ``num_devices`` > 1 and ``model_parallel`` > 1
  raise (ROADMAP.md A9); ``use_pallas`` is ignored (the wrappers pick the
  kernels by device);
- the model arrives built, its weights in its own ``Parameter``s (and
  Show-and-Tell's BatchNorm statistics in its buffers), which the step
  updates in place; the trainer loads ``encoder_weights``,
  ``load_pretrained`` + ``load_model_path`` and ``torch_checkpoint`` into
  them, and a resume copies ``state-last.pt`` into the same tensors;
- step ``it`` of epoch ``e`` draws its crops, flips, scheduled sampling and
  dropout from ``KeyChain(seed).generator("train", e, it)``, so a resumed
  run replays the draws of the run it continues (not the JAX package's);
- the next batch is copied to the card (from pinned host memory,
  ``non_blocking``) before the current step is queued. The step reads
  whether its gradient norm is finite on every step (``TrainStep.apply``),
  a host synchronisation, so today the copy overlaps the host's work on the
  next step, not the card's on this one.
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from show_and_tell_tpu_torch import ckpt
from show_and_tell_tpu_torch.config import Config
from show_and_tell_tpu_torch.models import quantize
from show_and_tell_tpu_torch.obs.meters import StepTimer, ThroughputMeter
from show_and_tell_tpu_torch.obs.profiler import profile_trace
from show_and_tell_tpu_torch.train.preempt import PreemptionGuard, RssWatchdog
from show_and_tell_tpu_torch.train.schedule import lr_for_epoch, ss_prob_for_epoch
from show_and_tell_tpu_torch.train.step import make_train_state, make_train_step
from show_and_tell_tpu_torch.utils.rng import KeyChain

log = logging.getLogger(__name__)


class Trainer:
    def __init__(
        self,
        cfg: Config,
        model,
        trainloader: Iterable,
        validloader: Optional[Iterable] = None,
        eval_fn: Optional[Callable] = None,
    ):
        """``eval_fn(params) -> (val_loss, predictions, lang_stats)``, with
        ``params`` the trainable tensors by state-dict name
        (``evalsuite.driver.make_trainer_eval_fn``); ``lang_stats`` must
        contain 'CIDEr' when cfg.language_eval == 1."""
        if cfg.multihost or cfg.num_devices > 1 or cfg.model_parallel > 1:
            raise NotImplementedError(
                "multihost, num_devices > 1 and model_parallel > 1: the port trains on one device; "
                "multi-device is not ported yet, see ROADMAP.md A9"
            )
        self.cfg = cfg
        self.model = model
        self.trainloader = trainloader
        self.validloader = validloader
        self.eval_fn = eval_fn
        self.device = next(model.parameters()).device
        self.keys = KeyChain(cfg.random_seed)

        if cfg.encoder_weights:
            from show_and_tell_tpu_torch.ckpt.torch_import import load_encoder_weights

            load_encoder_weights(cfg, model)
            log.info("loaded %s weights from %s", cfg.encoder, cfg.encoder_weights)
        # pretrained-weight start (config.py:33-36 surface)
        if cfg.load_pretrained and cfg.load_model_path:
            if ckpt.load_best_params(
                cfg.load_model_path, ckpt.trainable_state_dict(model), model.batch_stats
            ) is not None:
                log.info("loaded pretrained params from %s", cfg.load_model_path)
        if cfg.torch_checkpoint:
            # fine-tune from a reference-trained model-best.pth
            from show_and_tell_tpu_torch.ckpt.torch_import import apply_reference_checkpoint

            if not apply_reference_checkpoint(cfg, model) and not cfg.encoder_weights:
                log.warning(
                    "torch_checkpoint %s carries no encoder weights and encoder_weights is unset: "
                    "fine-tuning on top of a randomly initialized frozen encoder",
                    cfg.torch_checkpoint,
                )
            log.info("initialized trainable params from reference checkpoint %s", cfg.torch_checkpoint)

        self.state = make_train_state(cfg, model)
        self.train_step = make_train_step(model, cfg)
        self.timer = StepTimer()
        self.throughput = ThroughputMeter()

    # ------------------------------------------------------------------

    def eval_params(self) -> Dict[str, torch.Tensor]:
        """The weights evaluation and best-checkpointing use: the EMA average
        when ``cfg.ema_decay > 0`` (the averaged model is the one a user
        deploys), else the live params. Show-and-Tell's BatchNorm statistics
        are always the running ones, the model's buffers, which the EMA does
        not cover."""
        if self.state.ema_params is not None:
            return self.state.ema_params
        return self.state.params

    def _maybe_quantize_backbone(self, dev_batch: Dict[str, torch.Tensor]) -> None:
        """With ``cfg.quantize_backbone``, calibrate the frozen trunk's int8
        copy on the first batch of images (its first 32, through the eval
        transform; or load ``cfg.quantized_backbone_path``): every later
        training step, evaluation and served caption then runs the int8
        features. Nothing for a batch of features or a trunk without a
        recipe."""
        if "images" not in dev_batch or not quantize.needs_calibration(self.model, self.cfg):
            return
        quantize.calibrate_model(self.model, self.cfg, dev_batch["images"])
        log.info("frozen backbone quantized to int8 (calibrated on %d images)", min(32, len(dev_batch["images"])))

    _DEVICE_KEYS = ("captions", "lengths", "features", "images")

    def _to_device(self, batch) -> Dict[str, torch.Tensor]:
        """The array fields of a loader batch as tensors on the model's
        device; metadata (imgids, cocoids) stays on the host. To a card the
        copy is queued from pinned memory and does not wait."""
        out = {}
        for k in self._DEVICE_KEYS:
            if k in batch:
                t = torch.as_tensor(batch[k])
                if self.device.type == "cuda":
                    t = t.pin_memory().to(self.device, non_blocking=True)
                out[k] = t
        return out

    def train(self, preempt_guard: Optional[PreemptionGuard] = None) -> dict:
        """Run the training loop. ``preempt_guard``: an externally managed
        :class:`~show_and_tell_tpu_torch.train.preempt.PreemptionGuard`
        (tests, cluster-notice watchers); by default one is installed here
        for SIGTERM/SIGINT when ``cfg.preempt_save`` (trigger -> finish the
        step, save the full train state + infos, return)."""
        with contextlib.ExitStack() as stack:
            guard = preempt_guard
            if guard is None and self.cfg.preempt_save:
                guard = stack.enter_context(PreemptionGuard())
            if self.cfg.rss_preempt_gb > 0:
                # past the threshold the watchdog triggers the same clean
                # save; with preempt_save off there is still a programmatic
                # latch (no signal hooks), so the knob is never inert
                if guard is None:
                    guard = PreemptionGuard()
                stack.enter_context(RssWatchdog(guard, self.cfg.rss_preempt_gb))
            return self._train_loop(guard)

    def _resume(self, cfg: Config) -> Dict:
        """Restore ``cfg.start_from``: its infos, and the full train state,
        else the best params (the EMA re-seeded from them). Returns the
        infos, or {} when the directory holds none."""
        infos = ckpt.load_infos(cfg.start_from)
        if not infos:
            return {}
        # the copies land in the model's own Parameters and the state's
        # tensors, so self.state stays bound to the model
        if ckpt.load_train_state(cfg.start_from, self.state) is None:
            if ckpt.load_best_params(cfg.start_from, self.state.params, self.state.batch_stats) is not None:
                if self.state.ema_params is not None:
                    ckpt.copy_into(self.state.ema_params, self.state.params, "ema_params")
        log.info("resuming from %s", cfg.start_from)
        return infos

    def _train_loop(self, guard) -> dict:
        cfg = self.cfg
        infos = {}
        stale_preempt_flag = False
        if cfg.start_from is not None and not cfg.load_pretrained:
            infos = self._resume(cfg)
            # the flag is cleared on disk only at the next persist; a resume
            # that runs no new step (preempted on an epoch's last iteration)
            # must still rewrite infos
            stale_preempt_flag = infos.pop("preempted", None) is not None

        total_iteration = infos.get("total_iter", 0)
        loaded_iteration = infos.get("iter", 0)
        loaded_epoch = infos.get("epoch", 1)
        resumed_at = (loaded_epoch, loaded_iteration, total_iteration)
        val_result_history = infos.get("val_result_history", {})
        loss_history = infos.get("loss_history", {})
        lr_history = infos.get("lr_history", {})
        best_val_score = infos.get("best_val_score") if cfg.load_best_score else None
        # the lr and ss_prob each epoch applied (the learning-curve record)
        epoch_schedule = infos.get("epoch_schedule", {})
        # (epoch, it, total_iteration) of work done since the last persist;
        # the end of the run saves it
        unpersisted = None

        for epoch in range(1, 1 + cfg.max_epochs):
            if epoch < loaded_epoch:
                continue
            lr = lr_for_epoch(cfg, epoch)
            ss_prob = ss_prob_for_epoch(cfg, epoch)
            self.cfg = cfg = cfg.replace(current_lr=lr, ss_prob=ss_prob)
            epoch_schedule[str(epoch)] = {"lr": lr, "ss_prob": ss_prob}
            infos["epoch_schedule"] = epoch_schedule
            if hasattr(self.trainloader, "set_epoch"):
                self.trainloader.set_epoch(epoch)  # the resumed epoch's order

            # Resume replay: loaders with set_resume_skip drop the trained
            # batch plans (no decode); other batches are read and discarded
            # before they are copied to the device.
            skip_n = loaded_iteration if epoch == loaded_epoch else 0
            raw_skip = 0
            if skip_n and hasattr(self.trainloader, "set_resume_skip"):
                self.trainloader.set_resume_skip(skip_n)
            else:
                raw_skip = skip_n

            def _device_batches(discard: int):
                # one-batch lookahead: batch i+1's copy is queued before
                # step i
                it_ = iter(self.trainloader)
                for _ in range(discard):
                    if next(it_, None) is None:
                        return
                nxt = next(it_, None)
                if nxt is None:
                    return
                nxt_dev = self._to_device(nxt)
                for following in it_:
                    fol_dev = self._to_device(following)
                    yield nxt, nxt_dev
                    nxt, nxt_dev = following, fol_dev
                yield nxt, nxt_dev

            # The meters read the host clock once per log window, when the
            # lagged loss of the window before is fetched; the per-step time
            # is the window's average.
            window_t0 = time.perf_counter()
            window_items = window_steps = 0
            pending_log = None  # (epoch, it, metrics) awaiting its log line
            for off, (batch, dev_batch) in enumerate(_device_batches(raw_skip)):
                it = off + 1 + skip_n
                total_iteration += 1
                unpersisted = (epoch, it, total_iteration)
                self._maybe_quantize_backbone(dev_batch)
                generator = self.keys.generator("train", epoch, it, device=self.device)
                with profile_trace(
                    cfg.profile_dir, enabled=cfg.profile_dir is not None and cfg.profile_step == total_iteration
                ):
                    self.state, metrics = self.train_step(self.state, dev_batch, lr, ss_prob, generator)
                window_items += int(np.shape(batch["captions"])[0])
                window_steps += 1

                if it % cfg.log_step == 0:
                    # the lagged line first, so that step N's line reports
                    # the meters as of window N
                    if pending_log is not None:
                        self._log_step_line(*pending_log)
                    dt = time.perf_counter() - window_t0
                    self.timer.record(dt / window_steps)
                    self.throughput.update(window_items, dt)
                    window_t0 = time.perf_counter()
                    window_items = window_steps = 0
                    pending_log = (epoch, it, metrics)

                if total_iteration % cfg.save_checkpoint_every == 0:
                    best_val_score = self._checkpoint(
                        epoch, it, total_iteration, float(metrics["loss"]), lr, best_val_score,
                        val_result_history, loss_history, lr_history, infos,
                    )
                    unpersisted = None
                    stale_preempt_flag = False  # the persist rewrote infos
                    # eval and checkpoint I/O stay out of the timing window
                    window_t0 = time.perf_counter()
                    window_items = window_steps = 0

                if guard is not None and guard.triggered:
                    if pending_log is not None:
                        self._log_step_line(*pending_log)
                    self._emergency_save(
                        epoch, it, total_iteration, float(metrics["loss"]), best_val_score,
                        val_result_history, loss_history, lr_history, infos,
                    )
                    return infos
            if pending_log is not None:  # the lagged window at epoch end
                self._log_step_line(*pending_log)
                pending_log = None
            loaded_iteration = 0  # after the resumed epoch, run all iterations

        if unpersisted is not None or stale_preempt_flag:
            # the work after the last gate (no validation: the resume
            # artifact, the gate's schema); also when no new step ran but the
            # resume consumed a preempted flag, which the rewrite clears
            at = unpersisted if unpersisted is not None else resumed_at
            self._persist_state(*at, best_val_score, val_result_history, loss_history, lr_history, infos)
            log.info("end-of-run train state saved at epoch %d iter %d (total %d)", *at)
        return infos

    def _log_step_line(self, epoch, it, metrics) -> None:
        loss = float(metrics["loss"])
        log.info(
            "Epoch [%d/%d], Step [%d], Loss: %.4f, Perplexity: %5.4f, %.1f img/s, %.0f ms/step",
            epoch, self.cfg.max_epochs, it, loss, float(np.exp(loss)),
            self.throughput.items_per_sec, 1000 * (self.timer.avg_s or 0),
        )

    # ------------------------------------------------------------------

    def _emergency_save(
        self, epoch, it, total_iteration, train_loss, best_val_score,
        val_result_history, loss_history, lr_history, infos,
    ) -> None:
        """Preemption checkpoint: the periodic path's resume artifacts (full
        train state + infos) without the validation, as the grace window
        before SIGKILL is short. ``model-best`` is left as it is."""
        self._persist_state(
            epoch, it, total_iteration, best_val_score, val_result_history, loss_history,
            lr_history, infos, preempted=True,
        )
        log.warning(
            "preempted at epoch %d iter %d (total %d, loss %.4f): full train state saved to %s "
            "— resume with start_from",
            epoch, it, total_iteration, train_loss, self.cfg.expr_dir,
        )

    def _persist_state(
        self, epoch, it, total_iteration, best_val_score, val_result_history, loss_history,
        lr_history, infos, preempted: bool = False,
    ) -> None:
        """The one definition of the resume artifacts (infos + full train
        state), shared by the periodic checkpoint and the preemption save."""
        cfg = self.cfg
        infos.update(
            total_iter=total_iteration,
            iter=it,
            epoch=epoch,
            best_val_score=best_val_score,
            opt=cfg.to_dict(),
            val_result_history=val_result_history,
            loss_history=loss_history,
            lr_history=lr_history,
        )
        if preempted:
            infos["preempted"] = True
        ckpt.save_infos(cfg.expr_dir, infos)
        ckpt.save_train_state(cfg.expr_dir, self.state)

    def _checkpoint(
        self, epoch, it, total_iteration, train_loss, lr, best_val_score,
        val_result_history, loss_history, lr_history, infos,
    ):
        cfg = self.cfg
        val_loss, predictions, lang_stats = None, [], {}
        if self.eval_fn is not None:
            val_loss, predictions, lang_stats = self.eval_fn(self.eval_params())
        val_result_history[str(total_iteration)] = {
            "loss": val_loss,
            "lang_stats": lang_stats,
            # the reference stores every prediction (train.py:161); a bounded
            # sample keeps infos small
            "predictions_sample": predictions[:10],
        }
        loss_history[str(total_iteration)] = train_loss
        lr_history[str(total_iteration)] = lr

        if cfg.language_eval == 1 and lang_stats:
            current_score = lang_stats.get("CIDEr")
        elif val_loss is not None:
            current_score = -val_loss
        else:
            current_score = -train_loss

        best_flag = best_val_score is None or (current_score is not None and current_score > best_val_score)
        if best_flag:
            best_val_score = current_score

        self._persist_state(
            epoch, it, total_iteration, best_val_score, val_result_history, loss_history, lr_history, infos,
        )
        if best_flag:
            ckpt.save_best(cfg.expr_dir, self.eval_params(), self.state.batch_stats, infos)
            log.info("model saved to %s (score %.4f)", cfg.expr_dir, current_score or 0)
        return best_val_score
