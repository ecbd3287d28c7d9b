"""Training: AdamW, the train step, the data pipeline, checkpoints, the
fault-tolerant runner and compressed gradient all-reduce.

The counterpart of ``repro.train``.  Every tree is walked in the JAX
package's leaf order (:mod:`repro_torch.train.tree`), so a checkpoint
written by either package loads in the other bit for bit, and the
optimizer's global norm sums the leaves in the reference's order.
"""
