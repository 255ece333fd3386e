"""Multi-device layer of the port (port of ``repro.dist``).

Layout:
  sharding    the port's Mesh (shards round-robin over the cards, or on the
              CPU), ``shard_map`` over one axis, ``constrain`` + the
              registerable logical->mesh axis-rules table, ``device_put``
  collectives collectives over a mesh's blocks with the byte ledger, the
              error-feedback compressed psum
  batching    paper-§6 batch-over-arrays scheduling on crossbars and meshes

The reference's ``compat`` shims over jax versions and needs no
counterpart.
"""
