"""The port's analysis: how much work a step or a kernel is and how fast one
H100 could do it at best, and the dataplane contracts its code must keep.

* ``roofline`` — the H100 SXM's data-sheet rates and ``Roofline``, a step's
  compute, memory and collective times and its dominant term (a port of
  ``repro.analysis.roofline`` on these rates).
* ``analytic`` — ``analytic_terms``, a model step's FLOPs, HBM bytes and
  model FLOPs from its config, shape and placement (``MeshInfo``), with the
  reference's arithmetic; no hardware in it.
* ``bounds`` — each hand-written kernel's bytes, operations and bound
  (``bound_ms``), as pure functions of its shapes; ``chip_smoke.py``
  reads every kernel bound from here.
* ``contracts`` — the port's dataplane contract checker (a port of
  ``repro.analysis.contracts``; ``tools/check_contracts_torch.py``): every
  public ``kernels.ops`` entry and ``kernels.flash_attention.flash_attention``
  registered against its oracle, its plain version and the reference's
  oracle's name (ORACLE-PARITY, ORACLE-MISSING); the host mirrors of
  ``core/api.py`` written only in ``@mirror_guard`` methods (MIRROR-GUARD);
  every ``ctypes`` binding held against its ``extern "C"`` entry in
  ``csrc/*.cu`` (BIND-ARITY); and, at run time, each state entry updating
  its state in place (STATE-INPLACE).  The reference's checks that exist
  only for Pallas or XLA (aliases, scalar prefetch, donation, traced kernel
  bodies, ``pallas_sites``) do not apply; ``contracts.NOT_APPLICABLE`` says
  why, one by one.

Of the reference's ``analysis`` package, one module has no counterpart:
``hlo``.  It parses the XLA HLO text of a compiled program, which PyTorch
does not produce; the collective bytes it sums have a meaning only across
cards, which the port's meshes do not span yet (ROADMAP item 6); and the op
census the card's checks need is already each kernel wrapper's launch
count.

No module here imports torch when it is imported.
"""

from . import analytic, bounds, contracts, roofline  # noqa: F401
