"""Train and eval steps, port of ``make_train_step`` (the grad_accum == 1
path) and ``make_eval_step`` of ``convkan_tpu/train/loop.py``, with the
ImageNet preprocessing of ``imagenet=True`` (``imagenet_batch``; its
training augmentation is not ported yet).

One train step: on-device augmentation and normalization, a train-mode
forward (dropout on; each BatchNorm normalizes with the batch's statistics
and moves its running ones once, as JAX's ``mutable=["batch_stats"]``),
cross-entropy, backward, one AdamW update.  The eval step runs the model in
eval mode: BatchNorm reads its running statistics.  Every
tensor stays on the model's device and the step returns the loss as a
device tensor: nothing in it waits for the device.
"""

from __future__ import annotations

import torch

from .data import imagenet_batch, normalize_batch, train_batch
from .metrics import confusion_matrix, cross_entropy_loss
from .state import TrainState


def _param_dtype(model) -> torch.dtype:
    return next(model.parameters()).dtype


def make_train_step(model, dataset: str, augment: bool,
                    l1_decay: float = 0.0, imagenet: bool = False,
                    grad_accum: int = 1, label_smoothing: float = 0.0,
                    ema_decay: float = 0.0):
    """step(state, x_uint8, labels, *, offsets=None, flips=None) -> loss.
    Crop offsets and flips not passed in are drawn from
    ``state.generator``, then the forward's masks in module order: each
    block's convs' channel dropout, then its DropPath, then the head's
    dropout (a rematerialized block draws its masks again from the same
    state in the backward pass)."""
    unported = {"l1_decay > 0": l1_decay > 0,
                "imagenet with augment": imagenet and augment,
                "grad_accum != 1": grad_accum != 1, "ema_decay > 0":
                ema_decay > 0}
    for what, on in unported.items():
        if on:
            raise NotImplementedError(f"train step with {what} is not "
                                      "ported yet")

    def step(state: TrainState, x_uint8, labels, *, offsets=None,
             flips=None):
        if state.model is not model:
            raise ValueError("the train state holds another model")
        model.train()
        x = train_batch(x_uint8, dataset, augment, generator=state.generator,
                        offsets=offsets, flips=flips, imagenet=imagenet)
        logits = model(x.to(_param_dtype(model)), state.generator)
        loss = cross_entropy_loss(logits, labels,
                                  label_smoothing=label_smoothing)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.apply_gradients()
        return loss.detach()

    return step


def make_eval_step(model, dataset: str, num_classes: int,
                   imagenet: bool = False, use_ema: bool = False):
    """step(state, x_uint8, labels, weights) -> (weighted loss sum,
    confusion matrix), both device tensors; ``weights`` masks the padding
    of a partial batch."""
    if use_ema:
        raise NotImplementedError("eval step with use_ema is not ported yet")

    def step(state: TrainState, x_uint8, labels, weights):
        if state.model is not model:
            raise ValueError("the train state holds another model")
        model.eval()
        with torch.no_grad():
            x = (imagenet_batch(x_uint8, False, dataset) if imagenet else
                 normalize_batch(x_uint8, dataset)).to(_param_dtype(model))
            logits = model(x)
            logp = torch.log_softmax(logits, dim=-1)
            nll = -logp.gather(-1, labels.long()[:, None])[:, 0]
            loss_sum = (nll * weights.to(nll.dtype)).sum()
            cm = confusion_matrix(logits.argmax(dim=-1), labels, num_classes,
                                  weights=weights)
        return loss_sum, cm

    return step
