"""The port's bounds: how much work a step or a kernel is, and how fast one
H100 could do it at best.

* ``roofline`` — the H100 SXM's data-sheet rates and ``Roofline``, a step's
  compute, memory and collective times and its dominant term (a port of
  ``repro.analysis.roofline`` on these rates).
* ``analytic`` — ``analytic_terms``, a model step's FLOPs, HBM bytes and
  model FLOPs from its config, shape and placement (``MeshInfo``), with the
  reference's arithmetic; no hardware in it.
* ``bounds`` — each hand-written kernel's bytes, operations and bound
  (``bound_ms``), as pure functions of its shapes; ``chip_smoke.py``
  reads every kernel bound from here.

Of the reference's ``analysis`` package, two modules have no counterpart:

* ``hlo`` does not apply to the port.  It parses the XLA HLO text of a
  compiled program, which PyTorch does not produce; the collective bytes it
  sums have a meaning only across cards, which the port's meshes do not
  span yet (ROADMAP item 6); and the op census the card's checks need is
  already each kernel wrapper's launch count.
* ``contracts`` is still to be ported (ROADMAP item 7.1).

No module here imports torch.
"""

from . import analytic, bounds, roofline  # noqa: F401
