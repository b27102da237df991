"""The consensus layer's host time a committed step in the window: the
``submit`` of its ``step:`` record plus the ``pump(2)`` that follows, as the
benchmark's proxy of the staged ``PaxosContext`` times them, their mean in
milliseconds.  None where the window committed nothing."""


def read(run):
    if not run.commit_s:
        return None
    return 1e3 * sum(run.commit_s) / len(run.commit_s)
