"""Loss and train-step construction (port of ``repro/train/step.py``).

``make_train_step(cfg, opt_cfg)`` returns a :class:`TrainStep`, called as
``step(params, opt_state, batch) → (params, opt_state, metrics)`` like the
reference's pure step, with microbatch gradient accumulation in f32,
optional int8 gradient compression, FlexBlock masks (sparse fine-tuning:
grads masked before the AdamW update, params masked again after it, so
pruned weights stay exactly zero) and activation rematerialisation.

Two differences from the reference, both for memory at full width:

* the update is written in place into ``params`` and ``opt_state`` (the
  returned objects are the given ones);
* everything that can fail (forward, backward, compression) runs before
  the first write, and a non-finite loss writes nothing: the step reads
  the loss back to the host (the read the trainer makes anyway) and
  returns without an update.  The reference's step would apply the NaN
  update and its trainer throws it away; the trainer's behaviour is the
  same.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..configs.base import ArchConfig
from ..distributed.compress import compress_decompress_grads
from ..models.transformer import forward
from ..tree import leaves, leaves_with_paths, map_with_path
from .optimizer import AdamWConfig, adamw_update

__all__ = ["cross_entropy_loss", "make_loss_fn", "make_train_step", "TrainStep"]


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token-mean softmax cross entropy in f32; logits (B, S, V), labels
    (B, S); with ``mask`` a masked mean, its denominator floored at 1."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def make_loss_fn(cfg: ArchConfig) -> Callable:
    """Batch dict → scalar loss.  Batch keys: ``tokens``, ``labels``
    (+ ``prefix_embed`` for a prefix-LM, whose logits are sliced past
    ``cfg.prefix_len``; + ``enc_embed`` for an encoder-decoder; optional
    ``loss_mask``)."""

    def loss_fn(params, batch, *, remat: bool = False, remat_policy: str = "minimal"):
        kwargs = {}
        if cfg.prefix_len:
            kwargs["prefix_embed"] = batch["prefix_embed"]
        if cfg.enc_dec:
            kwargs["enc_embed"] = batch["enc_embed"]
        logits = forward(params, batch["tokens"], cfg, remat=remat,
                         remat_policy=remat_policy, **kwargs)
        if cfg.prefix_len:
            logits = logits[:, cfg.prefix_len:]
        return cross_entropy_loss(logits, batch["labels"], batch.get("loss_mask"))

    return loss_fn


def _apply_masks_(tree, masks) -> None:
    """Multiply, in place, each leaf of ``tree`` whose key path has a mask in
    ``masks`` by it (0/1 in the leaf's dtype); a path with no mask, or a
    ``None`` mask, leaves the leaf alone."""
    for path, leaf in leaves_with_paths(tree):
        m = masks
        try:
            for k in path:
                m = m[k]
        except (KeyError, TypeError):
            continue
        if m is not None:
            leaf.mul_(m)


class TrainStep:
    """The train step of :func:`make_train_step`.

    ``grads(params, batch)`` → (loss, grads) runs forward and backward (per
    microbatch, accumulated), then the compression; ``apply(params,
    opt_state, loss, grads)`` masks the grads, checks the loss, updates in
    place and masks the params.  ``on_stage(stage, grads)``, when set, is
    called after each stage: ``"grads"``, ``"grad masks"``, ``"optimizer"``,
    ``"param masks"`` (the last two only when an update is applied; the
    masks' only where there are masks); a caller may time the stages or
    read the grads there.
    """

    def __init__(self, cfg: ArchConfig, opt_cfg: AdamWConfig, *, microbatches: int = 1,
                 masks: Optional[Any] = None, compress_grads: bool = False,
                 remat: bool = False, remat_policy: str = "minimal"):
        self.cfg, self.opt_cfg = cfg, opt_cfg
        self.microbatches = microbatches
        self.masks = masks
        self.compress_grads = compress_grads
        self.remat, self.remat_policy = remat, remat_policy
        self.loss_fn = make_loss_fn(cfg)
        self.on_stage: Optional[Callable[[str, Any], None]] = None
        self._placed = False

    def _place_masks(self, params) -> None:
        """Move each mask to its param's device, once, at the first step
        (``prune_params`` keeps the masks of ``wo`` and of expert leaves on
        the host)."""
        if self.masks is not None and not self._placed:
            def place(path, m):
                p = params
                for k in path:
                    if not isinstance(p, dict) or k not in p:
                        return m
                    p = p[k]
                return m.to(p.device)
            self.masks = map_with_path(place, self.masks)
        self._placed = True

    def _stage(self, name: str, grads) -> None:
        if self.on_stage is not None:
            self.on_stage(name, grads)

    def _value_and_grad(self, params, batch) -> Tuple[torch.Tensor, Any]:
        """Loss and grads of one (micro)batch, grads in the param dtype (a
        param the loss does not reach gets zeros, as ``jax.grad`` gives)."""
        paths = list(leaves_with_paths(params))
        alias = {path: p.detach().requires_grad_() for path, p in paths}
        tree = map_with_path(lambda path, _: alias[path], params)
        with torch.enable_grad():
            loss = self.loss_fn(tree, batch, remat=self.remat, remat_policy=self.remat_policy)
            wrt = [alias[path] for path, _ in paths]
            got = torch.autograd.grad(loss, wrt, allow_unused=True)
        grads = {path: torch.zeros_like(w) if g is None else g
                 for (path, _), w, g in zip(paths, wrt, got)}
        return loss.detach(), map_with_path(lambda path, _: grads[path], params)

    def grads(self, params, batch) -> Tuple[torch.Tensor, Any]:
        """(loss, grads) of ``batch``: the mean over ``microbatches`` equal
        slices of its leading axis, accumulated in f32 (so f32 grads with
        more than one microbatch, the param dtype with one), then
        compressed where asked."""
        n = self.microbatches
        if n > 1:
            acc = map_with_path(lambda _, p: torch.zeros(p.shape, dtype=torch.float32,
                                                         device=p.device), params)
            loss_sum = 0.0
            for i in range(n):
                mb = {k: v.reshape((n, -1) + tuple(v.shape[1:]))[i] for k, v in batch.items()}
                loss, g = self._value_and_grad(params, mb)
                for a, gl in zip(leaves(acc), leaves(g)):
                    a.add_(gl)
                del g
                loss_sum = loss_sum + loss
            loss = loss_sum / n
            for a in leaves(acc):
                a.div_(n)
            grads = acc
        else:
            loss, grads = self._value_and_grad(params, batch)
        if self.compress_grads:
            grads = compress_decompress_grads(grads)
        return loss, grads

    def apply(self, params, opt_state, loss: torch.Tensor, grads
              ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
        """Mask the grads, then, where the loss is finite, the AdamW update
        and the masks on the params, in place.  Returns (params, opt_state,
        metrics): ``loss``, ``grad_norm`` and ``lr`` (the loss alone where
        it is not finite and nothing was written)."""
        self._place_masks(params)
        with torch.no_grad():
            if self.masks is not None:
                _apply_masks_(grads, self.masks)
                self._stage("grad masks", grads)
            if not math.isfinite(float(loss)):
                return params, opt_state, {"loss": loss}
            params, opt_state, metrics = adamw_update(grads, opt_state, params, self.opt_cfg)
            self._stage("optimizer", grads)
            if self.masks is not None:
                _apply_masks_(params, self.masks)
                self._stage("param masks", grads)
        return params, opt_state, dict(metrics, loss=loss)

    def __call__(self, params, opt_state, batch):
        loss, grads = self.grads(params, batch)
        self._stage("grads", grads)
        return self.apply(params, opt_state, loss, grads)


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig, *, microbatches: int = 1,
                    masks: Optional[Any] = None, compress_grads: bool = False,
                    remat: bool = False, remat_policy: str = "minimal") -> TrainStep:
    """The train step: ``(params, opt_state, batch) → (params, opt_state,
    metrics)``, written in place (see the module docstring).  ``masks``
    is ``prune_params``'s (``{"layers": {name: bool tensor | None}}``),
    matched to the params by key path; each mask moves to its param's
    device once, at the first step."""
    return TrainStep(cfg, opt_cfg, microbatches=microbatches, masks=masks,
                     compress_grads=compress_grads, remat=remat, remat_policy=remat_policy)
