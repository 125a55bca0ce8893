"""Lookahead data pipeline (counterpart of ``repro.data.lookahead``).

Batch N+1's sparse indices are visible while batch N trains, the enabler of
the relaxed lookup and of batch-aware checkpointing. ``LookaheadIterator``
keeps a window of materialised batches; ``peek_indices(k)`` exposes future
touched-row sets without consuming them.
"""
from __future__ import annotations

import collections

from repro_torch.core import relaxed as rx


class LookaheadIterator:
    def __init__(self, batches, cfg, depth: int = 2, start_step: int = 0):
        if depth < 2:
            raise ValueError("relaxed lookup needs >= 1 batch of lookahead")
        self.batches = batches
        self.cfg = cfg
        self.depth = depth
        self.step = start_step
        self.window: collections.deque = collections.deque()
        for i in range(depth):
            self.window.append(batches.next(start_step + i))

    def current(self) -> dict:
        return self.window[0]

    def peek(self, k: int = 1) -> dict:
        """Batch N+k without consuming (k < depth)."""
        return self.window[k]

    def peek_indices(self, k: int = 1):
        """The rows batch N+k WILL touch."""
        return rx.touched_indices(self.cfg, self.window[k])

    def advance(self) -> dict:
        """Consume batch N; extend the window."""
        out = self.window.popleft()
        self.step += 1
        self.window.append(self.batches.next(self.step + self.depth - 1))
        return out

    def next(self, step: int) -> dict:
        """Batch ``step``, the train loop's accessor. A step past the window
        slides it forward, keeping the batches the two windows share, so a
        loop that asks for N and N+1 at step N makes one batch per step.
        A step before the window is made afresh."""
        offset = step - self.step
        if offset >= self.depth:
            self._slide(step - self.depth + 1)
            offset = self.depth - 1
        if 0 <= offset:
            return self.window[offset]
        return self.batches.next(step)

    def _slide(self, start: int) -> None:
        """Re-seat the window at ``start`` (> self.step)."""
        while self.window and self.step < start:
            self.window.popleft()
            self.step += 1
        self.step = start
        while len(self.window) < self.depth:
            self.window.append(self.batches.next(self.step + len(self.window)))
