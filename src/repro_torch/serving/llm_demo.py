"""LLM serving demo: length-bucketed batching, prefill + decode, sampling.

Port of the JAX package's ``repro.serving.llm_demo``, the language-model
serving demo of the LM wing (it has nothing to do with the graph engine).
The batcher buckets queued requests by prompt length (uniform-length
batches keep the cache layout exact: no left-pad attention pollution),
prefills each bucket as one batch, then decodes all sequences in lockstep
with per-request stop handling. Greedy, temperature or top-k sampling; the
random draws come from a ``torch.Generator`` seeded from ``seed``, so they
differ from the reference's ``jax.random`` draws.
"""
from __future__ import annotations

import dataclasses
import time
from collections import defaultdict
from typing import Sequence

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import Model, Transformer

__all__ = ["Request", "ServeEngine", "sample_token"]


@dataclasses.dataclass
class Request:
    request_id: int
    prompt: list[int]
    max_new_tokens: int = 16
    temperature: float = 0.0  # 0 => greedy
    top_k: int = 0
    eos_id: int | None = None


def sample_token(
    logits: torch.Tensor, generator: torch.Generator, temperature: float, top_k: int
) -> torch.Tensor:
    """logits: (B, V). Returns (B,) int64 token ids."""
    if temperature <= 0.0:
        return logits.argmax(dim=-1)
    logits = logits / temperature
    if top_k:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, float("-inf"), logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


class ServeEngine:
    """Stateless-model, stateful-queue serving engine.

    ``params`` is a :class:`~repro_torch.models.Transformer`; the engine runs
    on its device. Without ``params`` it draws random weights from ``seed``
    on ``device`` (``None``: the CUDA card, an error without one).
    ``stats`` gets one entry per bucket served: its batch, prompt length,
    the seconds from the start of :meth:`run` to its first tokens, and its
    decode steps and seconds (host clock; each step ends in a copy of the
    sampled tokens to the host, so no extra synchronisation is needed).
    """

    def __init__(
        self,
        cfg: ModelConfig,
        params: Transformer | None = None,
        *,
        max_batch: int = 8,
        seed: int = 0,
        device=None,
    ):
        if params is None:
            self.model = Model(cfg, device=device)
            params = self.model.init(seed)
        else:
            if device is not None and torch.device(device) != params.device:
                raise ValueError(f"params are on {params.device}, not {device}")
            self.model = Model(cfg, device=params.device)
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.generator = torch.Generator(device=self.model.device).manual_seed(seed)
        self.stats: list[dict] = []
        self._queue: list[Request] = []

    # -- queue ------------------------------------------------------------
    def submit(self, req: Request) -> None:
        self._queue.append(req)

    def _take_bucket(self) -> list[Request]:
        """Pop up to max_batch requests sharing one prompt length."""
        if not self._queue:
            return []
        by_len: dict[int, list[Request]] = defaultdict(list)
        for r in self._queue:
            by_len[len(r.prompt)].append(r)
        # largest bucket first: maximizes batch utilization
        length = max(by_len, key=lambda k: len(by_len[k]))
        bucket = by_len[length][: self.max_batch]
        taken = set(id(r) for r in bucket)
        self._queue = [r for r in self._queue if id(r) not in taken]
        return bucket

    # -- execution ----------------------------------------------------------
    def run(self) -> dict[int, list[int]]:
        """Drain the queue; returns request_id -> generated token list."""
        results: dict[int, list[int]] = {}
        t0 = time.perf_counter()
        while self._queue:
            bucket = self._take_bucket()
            results.update(self._run_bucket(bucket, t0))
        return results

    @torch.no_grad()
    def _run_bucket(self, bucket: Sequence[Request], t0: float) -> dict[int, list[int]]:
        b = len(bucket)
        prompt_len = len(bucket[0].prompt)
        max_new = max(r.max_new_tokens for r in bucket)
        max_len = prompt_len + max_new + 1
        stats = {"batch": b, "prompt_len": prompt_len, "started_s": time.perf_counter() - t0}
        tokens = torch.tensor(
            [r.prompt for r in bucket], dtype=torch.long, device=self.model.device
        )
        last_logits, cache = self.model.prefill(self.params, tokens, max_len=max_len)
        out: dict[int, list[int]] = {r.request_id: [] for r in bucket}
        done = [False] * b
        cur = last_logits[:, 0, : self.cfg.vocab_size]
        steps = 0
        t_first = None
        for t in range(max_new):
            temps = bucket[0].temperature  # per-bucket sampling params
            topk = bucket[0].top_k
            nxt = sample_token(cur.float(), self.generator, temps, topk)
            nxt_host = nxt.tolist()
            if t_first is None:
                t_first = time.perf_counter()
                stats["first_token_s"] = t_first - t0
            for i, r in enumerate(bucket):
                if done[i] or t >= r.max_new_tokens:
                    done[i] = True
                    continue
                tok = nxt_host[i]
                out[r.request_id].append(tok)
                if r.eos_id is not None and tok == r.eos_id:
                    done[i] = True
            if all(done):
                break
            logits, cache = self.model.decode(self.params, cache, nxt[:, None], prompt_len + t)
            cur = logits[:, 0, : self.cfg.vocab_size]
            steps += 1
        stats["decode_steps"] = steps
        stats["decode_s"] = time.perf_counter() - t_first if t_first is not None else 0.0
        self.stats.append(stats)
        return out
