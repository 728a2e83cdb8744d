"""deep3d_aerial_tpu_torch: the aerial MVS pipeline in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The counterpart of the JAX package `deep3d_aerial_tpu`, which it mirrors
module by module and never imports. Ported so far: the default pipeline
end to end -- view selection, dense matching (AdaMVS, MSREDNet, CasMVSNet,
UCSNet), fusion, mesh and DSM (see ROADMAP.md for what follows).

Subpackages
-----------
geometry  : camera conventions, projection algebra (copied host code)
io        : PFM / predef text / PLY / OpenMVS .mvs / GeoTIFF codecs (copied
            host code)
ops       : warp, samplers, resize, and the CUDA kernels' wrappers
csrc      : CUDA C++ sources of the kernels, built at first use
models    : AdaMVS, MSREDNet, CasMVSNet, UCSNet and their blocks
fusion    : consistency check + depth-map fusion
mesh      : graph-cut reconstruction, clean, refine (photometric refine in
            PyTorch autograd), texture atlas
dsm       : DSM rasterisation from points and meshes
sparse    : COLMAP ingest and view selection (copied host code)
utils     : the native library's ctypes bridge (g++ at first use), CSR
            visibility, profiler sessions
pipeline  : config, dataset, orchestrator and CLI
weights   : JAX parameter tree -> state_dict bridge
"""

__version__ = "0.1.0"
