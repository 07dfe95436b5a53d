"""The parallel layer (the port of ``repro/parallel``) on
``torch.distributed``.

* :mod:`.api` — the sharding-constraint side channel: ``constrain`` names
  an intermediate, a rule table installed by ``sharding_rules`` maps
  names to specs; on a mesh it redistributes the DTensor to the rule's
  placements and holds its gradient there, on one device it returns its
  input unchanged.  ``redistribute``, ``hold`` and the port's own
  ``local_map`` name every gradient's placement, so a sharded step lays
  out alike on every torch version.
* :mod:`.sharding` — the rule tables: parameter, optimizer, batch, cache
  and activation specs per (config, mesh), pure functions of the config,
  a mesh (a :class:`repro_torch.launch.mesh.Mesh` record or a
  ``DeviceMesh``) and shape trees; ``placements`` turns a spec into
  DTensor placements and ``distribute`` places a tree by its specs.
* :mod:`.pipeline` — the GPipe wavefront over S stages: stage s on rank s
  of a mesh axis, activations handed on by point-to-point sends, or the
  stages in turn on one device.

``repro/parallel/compat.py`` has no counterpart: it only holds shims over
jax versions (``AxisType``, ``shard_map``'s renamed keyword), and the
port calls no jax.
"""
