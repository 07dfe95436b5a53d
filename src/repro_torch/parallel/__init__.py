"""The parallel layer (the port of ``repro/parallel``) for one card.

* :mod:`.api` — the sharding-constraint side channel: ``constrain`` names
  an intermediate, a rule table installed by ``sharding_rules`` maps
  names to specs; on one card it returns its input unchanged.
* :mod:`.sharding` — the rule tables: parameter, optimizer, batch, cache
  and activation specs per (config, mesh), pure functions of the config,
  a :class:`repro_torch.launch.mesh.Mesh` record and shape trees.
* :mod:`.pipeline` — the GPipe wavefront over S stages, its stages run
  in turn on the one card.

``repro/parallel/compat.py`` has no counterpart: it only holds shims over
jax versions (``AxisType``, ``shard_map``'s renamed keyword), and the
port calls no jax.
"""
