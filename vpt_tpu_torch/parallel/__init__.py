"""Distribution over a process group (counterpart of vpt_tpu/parallel/):
the mesh and the rows each rank owns (mesh.py), FSDP2 (fsdp.py), tensor
parallelism (tp.py), the trainers' wrapped model with sequence parallelism
(model.py) and the pipelined block stack (pp.py)."""
