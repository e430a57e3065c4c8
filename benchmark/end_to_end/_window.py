"""What the end-to-end metrics read: the window's steps [(start, end,
answers)], its length (from its start to the end of its last step), the
set-up time and the unit of an answer."""

from __future__ import annotations


def answers(ctx) -> int:
    return sum(n for _, _, n in ctx["steps"])


def rate(ctx) -> float:
    """Answers completed over the whole window, per second."""
    return answers(ctx) / ctx["window_s"]


def step_ms(ctx) -> list[float]:
    return [(e - s) * 1e3 for s, e, _ in ctx["steps"]]
