"""The LM side: the dense decoder-only family on the port's kernels.

* ``layers``      — param specs, norms, rotary, attention (K9 on the card), MLP.
* ``transformer`` — the dense transformer: specs, forward, prefill, decode.
* ``registry``    — one interface per family (``dense`` only so far).
* ``convert``     — the reference's parameter tree or train state, as numpy,
  into the port's, and a train state back.
"""
