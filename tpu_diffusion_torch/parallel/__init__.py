"""Parallelism over `torch.distributed`: the ("data", "model") mesh
(`mesh.py`), multi-process initialisation (`distributed.py`), tensor
parallelism by gather at use (`tp.py`), ring-attention sequence
parallelism (`sp.py`) and the sharded dry run (`dryrun.py`). Counterpart
of `tpu_diffusion/parallel/`."""
