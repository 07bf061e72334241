"""Data parallelism on ``torch.distributed`` (counterpart of
``eelunet_tpu/parallel/``): the process-group runtime (``distributed.py``)
and the device mesh (``mesh.py``). Only the ``data`` axis is ported; the
``model`` and ``spatial`` axes raise ``NotImplementedError``."""

from eelunet_tpu_torch.parallel.mesh import Mesh, create_mesh, spatial_size

__all__ = ["Mesh", "create_mesh", "spatial_size"]
