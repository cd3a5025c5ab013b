"""Dataset converters (this package's own copy of
``learn_nerf_tpu.convert``: NumPy and PIL only, the same CLIs and the same
output files):

* :mod:`.blender`: original-NeRF Blender-synthetic ``transforms_*.json``;
* :mod:`.llff`: LLFF ``poses_bounds.npy`` real scenes.

The JAX package's ``blender_script*.py`` exporters run inside Blender and
are not ported.
"""
