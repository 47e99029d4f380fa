"""Constants of the PSF surrogate (copied from `aadff_tpu/constants.py:38-39`)."""

# Depth normalisation range of the PSF surrogate [mm].  PSFNet works in
# negative millimetres and uses d_min = -DMIN, d_max = -DMAX.
DMIN = 200.0
DMAX = 20000.0
