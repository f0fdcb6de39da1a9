"""Batched serving loop: continuous batching over a decode step — twin of
``repro/serve/serving.py``.

Each serve step is ONE ``decode_step`` over the full slot batch; requests
join and leave slots between steps (continuous batching).  Slot state is
device-resident; the host only touches per-step token ids.  Prompts are
fed by decode, one token per step (prefill-by-decode), and each new token
is the greedy argmax.

One departure from the reference: a request admitted to a slot starts from
an empty cache.  The reference keeps the previous occupant's conv window
and SSD state in a reused slot, so a request's answer there depends on
which request held the slot before it (ROADMAP Queue C); here batching
changes no answer.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch


@dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new: int
    out: list[int] = field(default_factory=list)
    done: bool = False


class Server:
    """Fixed-slot continuous batching server over an LM."""

    def __init__(self, lm, params, *, slots: int, max_len: int):
        self.lm = lm
        self.params = params
        self.slots = slots
        self.cache = lm.init_cache(slots, max_len, params=params)
        self.active: list[Optional[Request]] = [None] * slots
        self.pending: list[Request] = []
        self.tokens = np.zeros((slots, 1), np.int32)
        self._step = lm.decode_step

    def submit(self, req: Request) -> None:
        self.pending.append(req)

    def _admit(self) -> None:
        for i in range(self.slots):
            if self.active[i] is None and self.pending:
                req = self.pending.pop(0)
                self.active[i] = req
                # prefill-by-decode: feed prompt tokens one at a time
                req._cursor = 0
                self.tokens[i, 0] = req.prompt[0]
                for leaf in self.cache["layers"].values():
                    leaf[:, i] = 0          # (layers, slots, ...)

    def step(self) -> None:
        self._admit()
        logits, self.cache = self._step(
            self.params, self.cache,
            torch.as_tensor(self.tokens, device=self.lm.device))
        nxt = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
        for i, req in enumerate(self.active):
            if req is None:
                continue
            req._cursor += 1
            if req._cursor < len(req.prompt):
                self.tokens[i, 0] = req.prompt[req._cursor]   # still prefilling
                continue
            req.out.append(int(nxt[i]))
            self.tokens[i, 0] = nxt[i]
            if len(req.out) >= req.max_new:
                req.done = True
                self.active[i] = None

    def run(self, max_steps: int = 1000) -> int:
        """Step until every request is done or ``max_steps`` have run;
        returns the steps taken."""
        steps = 0
        while (self.pending or any(self.active)) and steps < max_steps:
            self.step()
            steps += 1
        return steps
