"""Training substrate: so far ``elastic`` (membership views agreed through
the consensus log).  The rest of the reference's ``train`` is still to port
(``ROADMAP.md`` queue 1, item 8.6)."""

from . import elastic  # noqa: F401
