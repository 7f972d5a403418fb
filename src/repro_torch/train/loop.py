"""Fault-tolerant training driver (port of ``repro.train.loop``).

``train(...)`` wires together: synthetic data, the train step, async
checkpointing with keep-N, automatic restore-latest on start (so a
restarted job resumes), failure-injection-driven crash recovery (the
in-process analogue of a preemption restart loop), and the straggler
watchdog. Checkpoints are the reference's files (``train.state.
checkpoint_tree``). Runs on the CUDA card unless ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import SyntheticLM, SyntheticLMConfig
from repro_torch.device import resolve_device
from repro_torch.optim import AdamW
from repro_torch.reliability.faults import FailureInjector, SimulatedFailure, StragglerWatchdog
from repro_torch.train.state import (
    abstract_train_state,
    checkpoint_tree,
    decay_mask,
    load_checkpoint_tree,
    make_train_state,
)
from repro_torch.train.step import make_train_step

__all__ = ["TrainLoopConfig", "train"]


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 100
    checkpoint_every: int = 20
    checkpoint_dir: str = os.path.join(tempfile.gettempdir(), "repro_ckpt")
    keep: int = 3
    seed: int = 0
    seq_len: int = 128
    global_batch: int = 8
    learning_rate: float = 3e-4
    clip_norm: float = 1.0
    accum_steps: int = 1
    grad_sync: str = "none"
    log_every: int = 10
    max_recoveries: int = 10


def _restore(ckpt: CheckpointManager, cfg, optimizer, state: dict) -> tuple[dict, int]:
    tree, step = ckpt.restore(checkpoint_tree(cfg, abstract_train_state(cfg, optimizer)))
    return load_checkpoint_tree(cfg, state, tree), step


def train(
    cfg: ModelConfig,
    loop: TrainLoopConfig,
    *,
    failure_injector: FailureInjector | None = None,
    on_metrics: Callable[[int, dict], None] | None = None,
    device=None,
) -> dict:
    """Run (or resume) training. Returns the reference's summary stats, and
    ``state``, the final train state.

    Crash recovery: any SimulatedFailure inside the step loop triggers
    restore-from-latest and continues — the whole path a production
    controller would drive across processes, exercised in-process. The
    optimizer is the reference's ``AdamW(weight_decay=0.01)`` with its
    default decay mask as the reference's stacked tree gives it
    (``train.state.decay_mask``).
    """
    dev = resolve_device(device)
    optimizer = AdamW(learning_rate=loop.learning_rate, weight_decay=0.01, decay_mask=decay_mask(cfg))
    step_fn = make_train_step(
        cfg, optimizer, clip_norm=loop.clip_norm, accum_steps=loop.accum_steps, grad_sync=loop.grad_sync,
    )
    data = SyntheticLM(
        SyntheticLMConfig(
            vocab_size=cfg.vocab_size, seq_len=loop.seq_len, global_batch=loop.global_batch, seed=loop.seed,
        )
    )
    ckpt = CheckpointManager(loop.checkpoint_dir, keep=loop.keep)
    watchdog = StragglerWatchdog()

    state = make_train_state(cfg, optimizer, loop.seed, device=dev)
    start_step = 0
    if ckpt.latest_step() is not None:
        state, start_step = _restore(ckpt, cfg, optimizer, state)

    losses: list[float] = []
    recoveries = 0
    step = start_step
    while step < loop.total_steps:
        try:
            t0 = time.perf_counter()
            if failure_injector is not None:
                failure_injector.check(step)
            batch = {k: torch.from_numpy(v).to(dev) for k, v in data.batch(step).items()}
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            losses.append(loss)
            dt = time.perf_counter() - t0
            watchdog.update(step, dt)
            if on_metrics is not None:
                on_metrics(step, {**{k: float(v) for k, v in metrics.items()}, "sec": dt})
            if loop.log_every and step % loop.log_every == 0:
                print(f"step {step:5d} loss {loss:.4f} ({dt:.2f}s)")
            step += 1
            if step % loop.checkpoint_every == 0 or step == loop.total_steps:
                ckpt.save(step, checkpoint_tree(cfg, state))
        except SimulatedFailure as e:
            recoveries += 1
            if recoveries > loop.max_recoveries:
                raise
            print(f"!! {e} — recovering from latest checkpoint")
            # recovery: rebuild a fresh state, restore latest (or restart
            # from scratch if nothing was saved yet)
            state = make_train_state(cfg, optimizer, loop.seed, device=dev)
            if ckpt.latest_step() is not None:
                state, step = _restore(ckpt, cfg, optimizer, state)
            else:
                step = 0
    ckpt.wait()
    return {
        "final_step": step,
        "losses": losses,
        "recoveries": recoveries,
        "stragglers": list(watchdog.flagged),
        "first_loss": losses[0] if losses else float("nan"),
        "last_loss": losses[-1] if losses else float("nan"),
        "state": state,
    }
