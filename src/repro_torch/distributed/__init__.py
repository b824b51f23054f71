"""The mesh tier: an in-process 1-D ``("data",)`` mesh of device slots.

``meshes``    ``DataMesh`` / ``data_mesh`` / ``num_shards`` and the active
              mesh context.
``cutjoin``   block-sharded decomposition joins over cut axis 0 (the
              kernel tier's tile entry points on each slot's row slice),
              the sharded dense f64 joins, and ``MeshExecutor`` (request
              fan-out over the slots).
``contract``  bucket elimination with the adjacency held as per-slot row
              blocks (``sharded_hom``); free tensors stay as the slots
              made them (``Sliced``) for the join tier.
"""
