"""Placement of the port's dataplanes on devices, and the LM serving command line.

* ``mesh`` — ``GroupMesh`` and ``make_group_mesh``, the ``groups`` axis the
  groups-sharded dataplane partitions its slabs over.
* ``serve`` — the batched LM serving command line (``python -m
  repro_torch.launch.serve``).
"""
