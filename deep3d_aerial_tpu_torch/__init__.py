"""deep3d_aerial_tpu_torch: the aerial MVS pipeline in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The counterpart of the JAX package `deep3d_aerial_tpu`, which it mirrors
module by module and never imports. Ported so far: AdaMVS dense matching
and depth fusion (see ROADMAP.md for what follows).

Subpackages
-----------
geometry  : camera conventions, projection algebra (copied host code)
io        : PFM / predef text / PLY codecs (copied host code)
ops       : warp, samplers, resize, and the CUDA kernels' wrappers
csrc      : CUDA C++ sources of the kernels, built at first use
models    : AdaMVS and its blocks
fusion    : consistency check + depth-map fusion
pipeline  : config, dataset, orchestrator and CLI
weights   : JAX parameter tree -> state_dict bridge
"""

__version__ = "0.1.0"
