"""Seconds from the process's start to the window's start: imports, the
kernel library, the inputs, the models and the warm-up step."""


def value(ctx) -> float:
    return ctx["setup_s"]
