"""Production mesh construction on ``torch.distributed``.

The counterpart of ``repro.launch.mesh``, with its axis names and
shapes:

* single pod = 16 x 16 = 256 ranks, axes (data, model);
* multi-pod  = 2 pods = 512 ranks, axes (pod, data, model); the "pod"
  axis carries only data parallelism, the "model" axis never crosses
  pods.

A mesh is a ``DeviceMesh`` over the current default process group,
which must hold exactly as many ranks as the mesh (``launch.train``
joins or starts one; ``launch.dryrun`` starts a fake group of that
size).  Defined as functions: importing this module touches no process
group.
"""

from __future__ import annotations


def _device_mesh(shape, names, device_type):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized():
        raise RuntimeError(f"a {shape} mesh needs a process group of {n} "
                           f"ranks; none is initialised")
    if dist.get_world_size() != n:
        raise ValueError(f"a {shape} mesh needs {n} ranks; the process "
                         f"group has {dist.get_world_size()}")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _device_mesh(shape, axes, device_type)


def make_mesh(data: int, model: int, pod: int = 1, device_type="cuda"):
    """Arbitrary mesh (tests, elastic re-mesh after node loss)."""
    if pod > 1:
        return _device_mesh((pod, data, model), ("pod", "data", "model"),
                            device_type)
    return _device_mesh((data, model), ("data", "model"), device_type)


def data_parallel_size(mesh) -> int:
    n = 1
    for a, size in zip(mesh.mesh_dim_names, mesh.shape):
        if a in ("pod", "data"):
            n *= size
    return n
