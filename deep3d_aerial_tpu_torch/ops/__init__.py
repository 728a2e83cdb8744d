"""Plain ops (warp, depth samplers, resize, 'SAME' convs) and the
wrappers of the CUDA kernels (sweep, red_step2). Importing this package
builds nothing and loads no CUDA library."""
