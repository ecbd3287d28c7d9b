"""Entry points of the port: ``python -m repro_torch.launch.train``.

The counterpart of ``repro.launch``.  The reference's mesh, sharding,
dry-run, roofline and shape helpers target TPU pods; their one-card
counterparts come with the launch slice of the port.
"""
