"""Training loop: the train step (gradients, accumulation, compression,
clipping, the optimizer), checkpoint/restart and the watchdog -- the port
of ``repro/train/loop.py``.

``jax.value_and_grad`` becomes ``torch.autograd.grad`` over the parameter
leaves (a leaf the loss does not reach gets a zero gradient, as JAX
gives).  Under ``accum > 1`` every batch leaf has a leading microbatch
axis; the step loops over it and accumulates ``g / accum`` into fp32
zeros, as the reference's ``lax.scan`` does, so memory holds one
microbatch's activations.  Then, in the reference's order: error-feedback
compression, ``clip_by_norm``, the optimizer.  There is no ``jit``: the
step runs eagerly, and ``train`` synchronises the card before it reads a
step's time (on log steps and under a watchdog), where the reference
blocks on ``jax.block_until_ready``.  When the last step is also a
checkpoint step, the reference starts its async save and at once writes
the same ``step_<N>.tmp`` again synchronously (the two writers race, and
one can fail); ``train`` waits for the async save first.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import torch

from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train.compression import make_ef_transform
from repro_torch.train.fault import Watchdog
from repro_torch.train.optim import Optimizer, clip_by_norm
from repro_torch.train.tree import leaves, map_trees

__all__ = ["TrainState", "init_state", "make_train_step", "train",
           "TrainResult", "value_and_grad"]


@dataclasses.dataclass
class TrainState:
    step: torch.Tensor          # int32 scalar on the parameters' device
    params: Any
    opt_state: Any
    ef_buf: Any = None          # error-feedback buffer (compression)

    def tree_flatten(self):
        return (self.step, self.params, self.opt_state, self.ef_buf), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


def _device(tree) -> torch.device:
    return leaves(tree)[0].device


def init_state(params, opt: Optimizer, compress: bool = False) -> TrainState:
    ef = None
    if compress:
        ef_init, _ = make_ef_transform()
        ef = ef_init(params)
    return TrainState(step=torch.zeros((), dtype=torch.int32,
                                       device=_device(params)),
                      params=params, opt_state=opt.init(params), ef_buf=ef)


def _unflatten(tree, flat: list):
    """``tree``'s structure (dicts, sorted keys) with ``flat``'s leaves."""
    it = iter(flat)
    return map_trees(lambda _: next(it), tree)


def value_and_grad(loss_fn: Callable, params, *args):
    """``((loss, aux), grads)`` of ``loss_fn(params, *args)`` with respect
    to every leaf of ``params`` (the ``has_aux`` form of
    ``jax.value_and_grad``)."""
    flat = [p.detach().requires_grad_(p.is_floating_point())
            for p in leaves(params)]
    with torch.enable_grad():
        loss, aux = loss_fn(_unflatten(params, flat), *args)
        wrt = [p for p in flat if p.requires_grad]
        gs = iter(torch.autograd.grad(loss, wrt, allow_unused=True))
    grads = []
    for p in flat:
        g = next(gs) if p.requires_grad else None
        grads.append(torch.zeros_like(p) if g is None else g)
    aux = {k: v.detach() for k, v in aux.items()}
    return (loss.detach(), aux), _unflatten(params, grads)


def _microbatch(batch: dict, i: int) -> dict:
    return {k: v[i] for k, v in batch.items()}


def make_train_step(loss_fn: Callable, opt: Optimizer, *,
                    grad_clip: float = 1.0, compress: bool = False,
                    accum: int = 1):
    """loss_fn(params, batch) -> (loss, aux).  Returns the step function
    ``(state, batch) -> (state', aux)``.

    ``accum`` > 1: batch leaves have leading dims (accum, micro, ...);
    gradients average over the microbatches (memory stays at one
    microbatch)."""
    _, ef_apply = make_ef_transform()

    def grads_of(params, batch):
        if accum == 1:
            (loss, aux), g = value_and_grad(loss_fn, params, batch)
            return loss, aux, g
        acc = map_trees(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)
        losses, auxs = [], []
        for i in range(accum):
            (loss, aux), g = value_and_grad(loss_fn, params,
                                            _microbatch(batch, i))
            acc = map_trees(lambda a, b: a.add_(b / accum), acc, g)
            losses.append(loss)
            auxs.append(aux)
        aux = {k: torch.stack([a[k] for a in auxs]).float().mean()
               for k in auxs[0]}
        return torch.stack(losses).mean(), aux, acc

    def train_step(state: TrainState, batch):
        loss, aux, grads = grads_of(state.params, batch)
        if compress:
            grads, ef = ef_apply(grads, state.ef_buf)
        else:
            ef = state.ef_buf
        grads, gnorm = clip_by_norm(grads, grad_clip)
        new_params, new_opt = opt.update(
            grads, state.opt_state, state.params, state.step)
        aux = dict(aux)
        aux["grad_norm"] = gnorm
        return TrainState(step=state.step + 1, params=new_params,
                          opt_state=new_opt, ef_buf=ef), aux

    return train_step


@dataclasses.dataclass
class TrainResult:
    state: TrainState
    history: list
    step_times: list
    restarts: int = 0


def _sync(state: TrainState) -> None:
    dev = state.step.device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train(
    state: TrainState,
    train_step: Callable,
    batch_at: Callable,              # step -> batch (stateless data)
    n_steps: int,
    *,
    log_every: int = 10,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 100,
    ckpt_async: bool = True,
    watchdog: Optional[Watchdog] = None,
    fault_injector: Optional[Callable] = None,   # step -> None | raise
) -> TrainResult:
    """Run the loop with checkpointing and (optional) fault injection.

    Restart-on-failure is ``fault.run_with_restart`` around this function;
    data order is reproducible because batches derive from the step."""
    history, times = [], []
    start = int(state.step)
    for step in range(start, n_steps):
        if fault_injector is not None:
            fault_injector(step)
        t0 = time.perf_counter()
        state, aux = train_step(state, batch_at(step))
        if watchdog is not None or step % log_every == 0 or \
                step == n_steps - 1:
            _sync(state)
        dt = time.perf_counter() - t0
        times.append(dt)
        if watchdog is not None:
            watchdog.observe(step, dt)
        if step % log_every == 0 or step == n_steps - 1:
            history.append({"step": step,
                            **{k: float(v) for k, v in aux.items()}})
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            saver = ckpt_mod.save_async if ckpt_async else ckpt_mod.save
            saver(ckpt_dir, step + 1, state)
    if ckpt_dir:
        # the last step's async save may be writing step_<n_steps>.tmp:
        # let it finish before the final save writes the same directory
        ckpt_mod.wait_pending()
        ckpt_mod.save(ckpt_dir, n_steps, state)
    return TrainResult(state=state, history=history, step_times=times)
