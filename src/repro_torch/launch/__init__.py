"""Placement of the port's dataplanes on devices.

* ``mesh`` — ``GroupMesh`` and ``make_group_mesh``, the ``groups`` axis the
  groups-sharded dataplane partitions its slabs over.
"""
