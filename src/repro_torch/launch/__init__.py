"""Placement of the port's dataplanes on devices, and the LM command lines.

* ``mesh`` — ``GroupMesh`` and ``make_group_mesh``, the ``groups`` axis the
  groups-sharded dataplane partitions its slabs over, one device a shard;
  ``make_host_mesh`` and ``make_production_mesh``, the ``(data, model)``
  meshes on ``torch.distributed`` (re-exported here, as the reference's
  ``launch`` does).
* ``serve`` — the batched LM serving command line (``python -m
  repro_torch.launch.serve``).
* ``train`` — the training command line (``python -m repro_torch.launch.train``).
"""

from .mesh import make_host_mesh, make_production_mesh  # noqa: F401
