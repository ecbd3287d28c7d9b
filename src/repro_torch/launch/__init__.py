"""Entry points and the launch layer of the port, on ``torch.distributed``.

The counterpart of ``repro.launch``: ``mesh`` (a ``DeviceMesh`` with the
reference's axis names), ``sharding`` (its rules as DTensor placements),
``shapes``, ``analysis`` (an H100 roofline and collective accounting),
``dryrun`` (every cell traced on fake tensors over a fake process group),
``perf`` and ``train`` (``python -m repro_torch.launch.train``, on a
mesh).
"""
