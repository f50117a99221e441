"""The served captions' side of the serving checks.

``BeamRecorder`` keeps what the program's beam search
(``decode.dispatch.beam_search``) chose in every search it ran while
recording: at each step, the beam that each kept beam extends and the word
it adds; its final beams, best first; and their scores, the sums of the
log-probabilities that the program computed along each. The Captioner serves
the best beam's words and drops the rest; the check reads them back.

``judge`` holds a sample of served captions against the reference, which
replays each search's choices from the same image with its own state:
- ``score_err_nats``: the widest gap, over every final beam, between the
  program's score and the reference's log-probability of the same words
  (the decoder's logits along each beam, summed);
- ``topk_gap_nats``: the widest amount by which a candidate that the search
  did not keep outscores, in the reference's eyes, one that it kept, at any
  step, or the best final beam outscores the served one. At or below 0
  where every step kept the reference's k best of the candidates that its
  kept beams offer; rounding makes near-ties read a little above.
A served caption that is not the best final beam of a search of
``beam_size`` beams that the program ran reads ``MISSING`` on both.

How far a served caption lies below the reference's own beam search's best
is not compared: beam search is chaotic, and a near-tie in the first words
sends sound runs of the program to beams several nats apart either way.
Both numbers hold for a length penalty of 0, as the configurations state.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from harness import cell as cell_lib, plugins
from reference import models as ref

PAD_ID, END_ID, UNK_ID = 0, 2, 3
MISSING = 1.0e9  # the reading of a served caption that no sound search of the program produced

# (choices: (parents, words) [L, k] each, or None; final ids [k, L]; their scores [k])
Record = Tuple[Optional[Tuple[np.ndarray, np.ndarray]], np.ndarray, np.ndarray]


def words(ids: np.ndarray) -> List[str]:
    """The served string of each row of ids: the words up to ``<end>``."""
    out = []
    for row in ids:
        ws = []
        for i in row:
            if i == END_ID:
                break
            if i >= UNK_ID:
                ws.append("<unk>" if i == UNK_ID else f"w{i}")
        out.append(" ".join(ws))
    return out


def choices(par: np.ndarray, tok: np.ndarray, final: np.ndarray) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """One image's search as ``reference.models.replay`` takes it: from the
    parents of each of its T steps ``par [T, k]``, the words of all but the
    last ``tok [T - 1, k]`` and the final beams ``final [k, L]``, the parent
    and word of each kept beam at each of the L steps ``([L, k], [L, k])``,
    the last step's in the order of the final beams and each beam extending
    itself by ``<pad>`` after the search ended. None where the final beams
    do not follow from the steps."""
    T, k = par.shape
    L = final.shape[1]
    P = np.tile(np.arange(k), (L, 1))
    W = np.full((L, k), PAD_ID, dtype=np.int64)
    hist = np.zeros((k, 0), dtype=np.int64)
    fin = np.zeros(k, dtype=bool)
    for t in range(T - 1):
        p, w = par[t], tok[t]
        hist = np.concatenate([hist[p], np.where(fin[p], PAD_ID, w)[:, None]], axis=1)
        fin = fin[p] | (w == END_ID)
        P[t], W[t] = p, w
    free = [int(p) for p in par[T - 1]]
    for j, f in enumerate(final):
        p = next((p for p in free if np.array_equal(hist[p], f[: T - 1])), None)
        if p is None or (f[T:] != PAD_ID).any():
            return None
        free.remove(p)
        P[T - 1, j], W[T - 1, j] = p, f[T - 1]
    return P, W


class BeamRecorder:
    def __init__(self):
        # per search: its parents per step [B, k], its words per step but the
        # last [B * k], its final beams [B, k, L] and their scores [B, k]
        self.searches: List = []

    @contextlib.contextmanager
    def recording(self):
        """Record every beam search that ``decode.dispatch`` runs. The
        search's own tensors are kept where it made them, with no copy
        and no synchronisation; the final beams come from the search's own
        ``return_all``, the best of which it returns."""
        from show_and_tell_tpu_torch.decode import beam, dispatch

        orig_search, orig_gather = dispatch.beam_search, beam._gather_beams
        live: List[List] = []  # the parents of the search being recorded

        def gather(tree, parent, B, k):
            if live:
                live[0].append(parent)
            return orig_gather(tree, parent, B, k)

        def beam_search(step_fn, carry, batch, *args, **kw):
            parents, toks = [], []

            def step(c, tok):
                if parents:  # the words of the step before, not the start
                    toks.append(tok)
                return step_fn(c, tok)

            live[:] = [parents]
            try:
                ids, scores = orig_search(step, carry, batch, *args, **dict(kw, return_all=True))
            finally:
                live.clear()
            self.searches.append((parents, toks, ids, scores))
            return ids[:, 0], scores[:, 0]

        dispatch.beam_search, beam._gather_beams = beam_search, gather
        try:
            yield self
        finally:
            dispatch.beam_search, beam._gather_beams = orig_search, orig_gather

    def record(self, i: int, row: int) -> Record:
        """Search ``i``'s record of the image in its ``row``."""
        parents, toks, ids, scores = self.searches[i]
        B, k, _ = ids.shape
        par = torch.stack(parents)[:, row].cpu().numpy()
        tok = (torch.stack(toks).view(len(toks), B, k)[:, row].cpu().numpy() if toks
               else np.zeros((0, k), dtype=np.int64))
        final = ids[row].cpu().numpy()
        return choices(par, tok, final), final, scores[row].float().cpu().numpy()

    def in_order(self, start: int, stop: int, row: int) -> Record:
        """The record of the ``row``-th image of searches ``start:stop``,
        which ran over consecutive rows (a call's chunks, each padded to its
        bucket at its end)."""
        for i in range(start, stop):
            b = self.searches[i][2].shape[0]
            if row < b:
                return self.record(i, row)
            row -= b
        raise IndexError(row)


def judge(cfg, arch: Dict, weights, images: torch.Tensor, captions: List[str],
          records: List[Optional[Record]]) -> Dict[str, float]:
    """The numbers compared for ``captions`` served from ``images``, given
    the record of the program's search that served each (None: none did);
    a caption that no sound search of ``beam_size`` beams served as its
    best reads ``MISSING``."""
    k, n = cfg.beam_size, len(captions)
    err, gap = np.full(n, MISSING), np.full(n, MISSING)
    good = [i for i, (c, r) in enumerate(zip(captions, records))
            if r is not None and r[0] is not None and r[1].shape[0] == k and words(r[1][:1])[0] == c]
    if not good:
        return {"score_err_nats": MISSING, "topk_gap_nats": MISSING}
    dev = images.device
    par = torch.from_numpy(np.stack([records[i][0][0] for i in good])).to(dev)
    tok = torch.from_numpy(np.stack([records[i][0][1] for i in good])).to(dev)
    final = torch.from_numpy(np.stack([records[i][1] for i in good]))
    prog = torch.from_numpy(np.stack([records[i][2] for i in good])).double()
    with cell_lib.full_fp32():
        net = plugins.reference(cfg, weights, arch)
        g, ids, logp = ref.replay(net, ref.features_of(net, images[good], cfg.crop_size), par, tok)
    g, ids, logp = g.double().cpu(), ids.cpu(), logp.double().cpu()
    # the served caption is the best final beam; no other outscores it
    g = torch.maximum(g, logp.max(1).values - logp[:, 0])
    e = (prog - logp).abs().max(1).values
    same = (ids == final).flatten(1).all(1)
    err[good] = torch.where(same, e, torch.full_like(e, MISSING)).numpy()
    gap[good] = torch.where(same, g, torch.full_like(g, MISSING)).clamp(max=MISSING).numpy()
    return {"score_err_nats": float(err.max()), "topk_gap_nats": float(gap.max())}


def control(cfg, arch: Dict, weights, images: torch.Tensor, q) -> Dict[str, float]:
    """The same numbers for the reference put in the program's place and
    computed under ``q``: its beam search's captions, choices and scores."""
    with cell_lib.full_fp32():
        low = plugins.reference(cfg, weights, arch, q)
        ids, scores, par, tok = ref.beam_search(low, ref.features_of(low, images, cfg.crop_size), cfg.beam_size,
                                                cfg.max_decode_len)
        del low
    ids, scores = ids.cpu().numpy(), scores.float().cpu().numpy()
    par, tok = par.cpu().numpy(), tok.cpu().numpy()
    records = [((par[i], tok[i]), ids[i], scores[i]) for i in range(ids.shape[0])]
    return judge(cfg, arch, weights, images, words(ids[:, 0]), records)


def altered(captions: List[str], vocab_size: int) -> List[str]:
    """The fault of a token altered where it is produced: the second word of
    every caption replaced by another."""
    out = []
    for c in captions:
        ws = c.split()
        if len(ws) > 1:
            i = int(ws[1][1:]) if ws[1].startswith("w") else 4
            ws[1] = f"w{4 + (i + 7 - 4) % (vocab_size - 4)}"
        out.append(" ".join(ws))
    return out
