"""Tokens of every step completed in the window over the window's time; the
window ends at the end of its last step (host clock)."""


def read(run):
    return run.tokens / run.window_s
