"""Multi-device runtime: process groups and the (data, fsdp, tensor) mesh
(``mesh.py``), and the DiT's tensor-parallel layers (``tensor_parallel.py``)."""
