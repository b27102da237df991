"""The PyTorch and CUDA port of the CAANS dataplane (``repro``'s counterpart).

``repro_torch.core`` holds the protocol roles and the single-group,
multi-group and groups-sharded services; ``repro_torch.kernels`` the
hand-written CUDA kernels for Hopper, each with its plain PyTorch version
beside it; ``repro_torch.launch`` the ``groups`` mesh and the serving
command line; ``repro_torch.configs``, ``repro_torch.models`` and
``repro_torch.serve`` the dense LM and its serving engine.  Entry points run
on the card unless the caller passes ``device="cpu"``.
"""
