"""vpt_tpu_torch — the PyTorch/CUDA port of vpt_tpu for NVIDIA Hopper.

The JAX package ``vpt_tpu`` is the reference; this package mirrors its module
layout and names and imports nothing from it (nor from JAX).  Plain tensor
code is PyTorch; each kernel the JAX package wrote in Pallas is a kernel
written by hand for ``sm_90a`` (sources in ``csrc/``, built at first use into
``build/``).

  actions/    camera quantizer, action transformer, hierarchical mapping,
              device-side action decode
  models/     policy graph as nn.Modules (reference torch state_dict names)
  ops/        masks, relative bias, attention (plain + CUDA kernel), strided
              attention, resize, int8 dense layers and QAT
  checkpoint/ reference .model/.weights I/O, JAX variable import, native
              checkpoints (train state and data cursor), weight averaging
  agent/      MineRLAgent, IDMAgent
"""

__version__ = "0.1.0"
