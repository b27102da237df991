"""Hand-written CUDA kernels for Hopper (``csrc/``) and their dispatch.

* ``wirepath``    — K1, the fused Phase-2 round (one group, G groups, a cohort, a shard's
  slab), K5 its persistent form, K6 the packed shard round, and K2, the staged vote of the
  acceptor array.
* ``coordinator`` — K3, the sequencer.
* ``digest``      — K4, the snapshot seal's weighted fold, and its plain version.
* ``acceptor``    — K7, one acceptor's Phase-2 vote (K2's lane body).
* ``learner``     — K8, the learner's quorum, and its plain version.
* ``flash_attention`` — K9, online-softmax GQA attention (causal, sliding
  window), its plain version, the device router, and ``K9Attention``: K9
  under autograd, its backward pass the models' chunked softmax's gradient.
* ``ops``         — CPU tensors to the plain versions, CUDA tensors to the kernels.
* ``_build``      — compiles ``csrc/*.cu`` with ``nvcc`` on first use and loads
  each library with ``ctypes``.

Nothing here imports ``triton`` or builds a kernel at import time.
"""
