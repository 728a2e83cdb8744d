"""deep3d_aerial_tpu_torch: the aerial MVS pipeline in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The counterpart of the JAX package `deep3d_aerial_tpu`, which it mirrors
module by module and never imports. Ported so far: the default pipeline
end to end -- view selection, dense matching (AdaMVS, MSREDNet, CasMVSNet,
UCSNet), fusion, mesh and DSM -- with its other run modes and outputs
(the pipelined run, batched inference, .dmap, depth previews), the
standalone fusion CLI, and training (see ROADMAP.md for what follows).
`python -m deep3d_aerial_tpu_torch` is the pipeline's CLI.

Subpackages
-----------
geometry  : camera conventions, projection algebra (copied host code)
io        : PFM / predef text / PLY / OpenMVS .mvs and .dmap / GeoTIFF /
            LAS codecs, point tiles (copied host code)
ops       : warp, samplers, resize, and the CUDA kernels' wrappers
csrc      : CUDA C++ sources of the kernels, built at first use
models    : AdaMVS, MSREDNet, CasMVSNet, UCSNet and their blocks
fusion    : consistency check + depth-map fusion, its CLI, evaluation
mesh      : graph-cut reconstruction, clean, refine (photometric refine in
            PyTorch autograd), texture atlas
dsm       : DSM rasterisation from points and meshes
sparse    : COLMAP ingest and view selection (copied host code)
utils     : the native library's ctypes bridge (g++ at first use), CSR
            visibility, profiler sessions, log tee and stage timer
pipeline  : config, dataset, orchestrator, colour maps and CLI
train     : losses, datasets, optimizers, train step, checkpoints, trainer
            and CLI
weights   : JAX parameter tree -> state_dict bridge
"""

__version__ = "0.1.0"
