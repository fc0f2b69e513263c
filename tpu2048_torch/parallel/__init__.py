"""Data and tensor parallelism over ``torch.distributed`` (counterpart of
``tpu2048/parallel/``): the process group and its collectives
(``mesh.py``), the launch of the data-parallel trainer's ranks
(``train_step.py``; the step is ``train/loop.py``'s), and ``GameMLP``
sharded over a 'model' axis (``tensor_parallel.py``)."""

from .mesh import DataGroup, init_distributed, make_mesh, spawn  # noqa: F401
