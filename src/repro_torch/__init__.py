"""The PyTorch and CUDA port of the CAANS dataplane (``repro``'s counterpart).

``repro_torch.core`` holds the protocol roles and the single-group,
multi-group and groups-sharded services; ``repro_torch.kernels`` the
hand-written CUDA kernels for Hopper, each with its plain PyTorch version
beside it; ``repro_torch.launch`` the ``groups`` mesh and the serving and
training command lines; ``repro_torch.configs``, ``repro_torch.models``,
``repro_torch.serve`` and ``repro_torch.train`` the dense LM, its serving
engine and its training with consensus-committed steps and checkpoints.  Entry points run
on the card unless the caller passes ``device="cpu"``.
"""
