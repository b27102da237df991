"""The LM side: every model family of the reference on the port's kernels.

* ``layers``      — param specs, norms, rotary and sinusoidal positions,
  attention (K9 on the card), MLP, MoE.
* ``transformer`` — the dense, MoE and VLM decoder: specs, forward, prefill,
  decode.
* ``griffin``     — recurrentgemma: RG-LRU blocks and local attention.
* ``rwkv6``       — RWKV6: time-mix with the WKV recurrence, channel-mix.
* ``whisper``     — the encoder-decoder with cross-attention.
* ``registry``    — one interface per family.
* ``convert``     — the reference's parameter tree or train state, as numpy,
  into the port's, and a train state back.
"""
